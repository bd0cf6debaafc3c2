"""The device trace of a traced run: ``torch.profiler`` around a steady part
of the window, reduced to busy time, time by device operation and idle gaps
named by what the host was doing.

The busy share divides the union of the device operations' intervals by the
traced window's length on the host clock (from a synchronise at its start to
one at its end), so idle time at the window's edges counts.  A copy of the
sums by kernel name in the repository's ``chip_smoke.py`` (``_kernel_time``),
with that window.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


class Profiled:
    """``with Profiled(device, host_ops) as p: ...`` traces the block;
    ``p.summary`` after.  Without ``host_ops`` it records device operations
    alone, which costs the host next to nothing; with them it records every
    host operation too (several microseconds each), to name idle gaps.  On
    the CPU (tests) it traces host operations alone."""

    def __init__(self, device: str, host_ops: bool):
        self.cuda = device == "cuda"
        self.host_ops = host_ops or not self.cuda

    def _sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = (([ProfilerActivity.CPU] if self.host_ops else [])
                + ([ProfilerActivity.CUDA] if self.cuda else []))
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof = None
        self.summary = reduce_trace(events, window_s)
        return False


def _union(intervals):
    """Sorted (start, end) intervals merged; their total length."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged, sum(end - start for start, end in merged)


def _innermost(host, points):
    """For each time in ``points`` (sorted), the name of the latest-starting
    host event that covers it, or None."""
    out, heap, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            start, end, name = host[i]
            heapq.heappush(heap, (-start, end, name))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def reduce_trace(events: list, window_s: float, top: int = 10) -> dict:
    """Chrome-trace events (microseconds) of one traced window -> busy_s,
    window_s, device time by op name (seconds), the ``top`` device ops and
    the ``top`` idle-gap totals by "<harness span> / <innermost host op>"."""
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") in DEVICE_CATS and "dur" in e]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and "dur" in e)
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") == "cpu_op" and "dur" in e)
    by_name: dict[str, float] = {}
    for start, end, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (end - start) * 1e-6
    merged, busy_us = _union((s, e) for s, e, _ in dev)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    timed = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("cat") in HOST_CATS + DEVICE_CATS and "ts" in e]
    if merged and timed:
        first, last = min(s for s, _ in timed), max(e for _, e in timed)
        if merged[0][0] > first:
            gaps.insert(0, (first, merged[0][0]))
        if last > merged[-1][1]:
            gaps.append((merged[-1][1], last))
    starts = [g[0] for g in gaps]
    gap_names: dict[str, float] = {}
    for (start, end), span, op in zip(gaps, _innermost(spans, starts), _innermost(ops, starts)):
        name = f"{span or 'outside the harness spans'} / {op or 'no host op'}"
        gap_names[name] = gap_names.get(name, 0.0) + (end - start) * 1e-6
    return {"busy_s": busy_us * 1e-6, "window_s": window_s,
            "device_s": sum(by_name.values()), "by_name": by_name,
            "device_ops": _top(by_name, top), "idle_gaps": _top(gap_names, top)}


def _top(totals: dict, n: int) -> list:
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def share_of(summary: dict | None, parts: tuple) -> float | None:
    """The share (%) of all device-operation time spent in operations whose
    name holds one of ``parts``; None without a trace."""
    if not summary or not summary["device_s"]:
        return None
    spent = sum(s for name, s in summary["by_name"].items() if any(p in name for p in parts))
    return 100.0 * spent / summary["device_s"]
