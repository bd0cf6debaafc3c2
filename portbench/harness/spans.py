"""The program's own spans (``repro_torch.tracing``) joined with a device-only
trace of the same units: device time, idle gaps and host time by span.

*Clock.*  The spans are on the host's ``perf_counter_ns``, the trace on the
profiler's clock.  At the start and at the end of the traced window an anchor
op is launched between two ``perf_counter_ns`` readings: on the card
``torch.cuda._sleep`` (its kernel, ``spin_kernel``, is launched by nothing
else), whose ``cuda_runtime`` launch event the kernel's ``correlation`` finds;
on the CPU a ``cpu_op`` no program runs.  The launch event lies between the
two readings, which bounds the offset between the clocks by the call's few
microseconds.  Each anchor is launched ``TRIES`` times, ``GAPS_S`` apart, and
the tightest bracket kept; the two anchors must agree within ``AGREE_US``,
else ``ClockError``.  Launches are matched to their brackets by the offset
that most of them agree on, not by count: the gaps differ, so a launch the
trace lost shifts no other onto a wrong bracket.

*Device time by span.*  Each kernel, memcpy and memset is charged to the
innermost span that holds its launch: the latest-starting span open at the
launch on the launching thread or, where that thread has none open (the
autograd engine's thread in a backward), on any thread.  ``device_self_s`` is
what a span name was charged itself, ``device_total_s`` with its descendants.

*Idle gaps by span.*  Each gap in the union of the device operations, and at
the window's edges (the two anchors), is charged to the innermost span open at
the gap's start, on any thread.

*Host time and counts by span name*: the sum of its spans' lengths, their
number, and their numeric attrs summed (an attr named ``*_max``: the largest).

``ProgramWindow`` is the device-only ``Profiled`` of a traced run with the
join: it turns the program's tracing on for its block and leaves the summary
``Profiled`` gives, of the trace without the anchors, as it was.
``run_window`` is ``window.run_window`` with it, the join under the trace
summary's ``"program"``.  A program without ``repro_torch.tracing`` gives no
join, and every reader of one reads nothing.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import tempfile
import time

from portbench.harness import window
from portbench.harness.trace import DEVICE_CATS, Profiled, reduce_trace

ANCHOR_KERNEL = "spin_kernel"
ANCHOR_CPU_OP = "aten::special_bessel_j0"
ANCHOR_CYCLES = 1000
GAPS_S = (0.0003, 0.0007)  # between a mark's launches: unequal, hundreds of us
TRIES = len(GAPS_S) + 1
AGREE_US = 50.0
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class ClockError(ValueError):
    """The anchors disagree, or are missing from the trace."""


def program_tracing():
    """``repro_torch.tracing``, or None where the program has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


class Anchors:
    """Anchor launches bracketed by ``perf_counter_ns`` readings."""

    def __init__(self, device: str):
        import torch

        self.torch, self.cuda = torch, device == "cuda"
        self.x = torch.ones(4)
        self.marks: list[list[tuple[int, int]]] = []

    def _launch(self):
        if self.cuda:
            self.torch.cuda._sleep(ANCHOR_CYCLES)
        else:
            self.torch.special.bessel_j0(self.x)

    def mark(self) -> None:
        tries = []
        for k in range(TRIES):
            if k:  # a busy wait: a thread woken from a sleep launches slower
                end = time.perf_counter() + GAPS_S[k - 1]
                while time.perf_counter() < end:
                    pass
            t0 = time.perf_counter_ns()
            self._launch()
            tries.append((t0, time.perf_counter_ns()))
        self.marks.append(tries)


def _args(e: dict) -> dict:
    return e.get("args") or {}


def anchor_events(events: list) -> tuple[list, set]:
    """(the anchors' host events, sorted by start: the kernel's launch events
    on the card, the ``cpu_op`` on the CPU; the ids of every anchor event)."""
    kernels = [e for e in events
               if e.get("cat") == "kernel" and ANCHOR_KERNEL in e.get("name", "")]
    if kernels:
        corr = {_args(k).get("correlation") for k in kernels}
        host = [e for e in events if e.get("cat") in LAUNCH_CATS
                and _args(e).get("correlation") in corr]
    else:
        host = [e for e in events if e.get("cat") == "cpu_op" and e.get("name") == ANCHOR_CPU_OP]
    return sorted(host, key=lambda e: e["ts"]), {id(e) for e in kernels + host}


def clock_offset(events: list, marks: list) -> dict:
    """The trace's clock (us) less ``perf_counter_ns`` / 1000, from each mark's
    tightest bracket: ``offset_us`` (their mean), ``disagreement_us`` (largest
    less smallest), ``bound_us`` (the widest half-bracket) and the window the
    marks bound on the trace's clock, ``lo_us`` (the first mark's last launch
    ended) to ``hi_us`` (the last mark's first launch began)."""
    host, _ = anchor_events(events)
    if len(marks) < 2 or not host:
        raise ClockError(f"{len(host)} anchor launches in the trace for {len(marks)} marks")
    # every launch against every bracket: the offsets it allows, (lo, hi)
    pairs = [(e["ts"] + e.get("dur", 0.0) - t1 / 1e3, e["ts"] - t0 / 1e3, m, e)
             for e in host for m, tries in enumerate(marks) for t0, t1 in tries]

    def near(pair, x):
        return pair[0] - AGREE_US <= x <= pair[1] + AGREE_US

    x = max(((lo + hi) / 2 for lo, hi, _, _ in pairs),
            key=lambda x: sum(near(p, x) for p in pairs))
    offsets, bounds, lo_us, hi_us = [], [], None, None
    for m in range(len(marks)):
        mine = [p for p in pairs if p[2] == m and near(p, x)]
        if not mine:
            raise ClockError(f"no launch of clock anchor {m} in the trace")
        lo, hi, _, _ = min(mine, key=lambda p: p[1] - p[0])
        offsets.append((lo + hi) / 2)
        bounds.append(max((hi - lo) / 2, 0.0))
        if m == 0:
            lo_us = max(p[3]["ts"] + p[3].get("dur", 0.0) for p in mine)
        if m == len(marks) - 1:
            hi_us = min(p[3]["ts"] for p in mine)
    out = {"offset_us": sum(offsets) / len(offsets),
           "disagreement_us": max(offsets) - min(offsets), "bound_us": max(bounds),
           "lo_us": lo_us, "hi_us": hi_us}
    if out["disagreement_us"] > AGREE_US:
        raise ClockError(f"the clock anchors disagree by {out['disagreement_us']:.1f} us")
    return out


def _innermost(spans: list, points: list) -> list:
    """For each time in ``points`` (sorted), the latest-starting of ``spans``
    ((start, end, span), sorted) that holds it, or None."""
    out, heap, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            start, end, s = spans[i]
            heapq.heappush(heap, (-start, -s["id"], end, s))
            i += 1
        while heap and heap[0][2] <= t:
            heapq.heappop(heap)
        out.append(heap[0][3] if heap else None)
    return out


def _holders(intervals: list, queries: list) -> list:
    """For each (time, thread) in ``queries``: the innermost span on that
    thread, else on any thread, else None."""
    by_thread: dict = {}
    for iv in intervals:
        by_thread.setdefault(iv[2]["thread"], []).append(iv)
    order = sorted(range(len(queries)), key=lambda i: queries[i][0])
    anywhere = _innermost(intervals, [queries[i][0] for i in order])
    out = [None] * len(queries)
    for i, s in zip(order, anywhere):
        out[i] = s
    for tid, ivs in by_thread.items():
        mine = [i for i in order if queries[i][1] == tid]
        for i, s in zip(mine, _innermost(ivs, [queries[i][0] for i in mine])):
            if s is not None:
                out[i] = s
    return out


def _adopters(intervals: list) -> dict:
    """For each root span, by id: the innermost span of another thread that
    holds its start (the thread that waits on it: a backward's work on
    autograd's thread belongs to the span that called the backward)."""
    out = {}
    for tid in {iv[2]["thread"] for iv in intervals}:
        roots = [iv for iv in intervals if iv[2]["thread"] == tid and iv[2]["parent"] is None]
        others = [iv for iv in intervals if iv[2]["thread"] != tid]
        for (_, _, s), holder in zip(roots, _innermost(others, [iv[0] for iv in roots])):
            if holder is not None:
                out[s["id"]] = holder
    return out


def join(events: list, spans: list, marks: list) -> dict:
    """The program's spans against one device-only trace: see the module's
    docstring.  ``by_span[name]``: count, host_s, device_n (operations
    charged), device_self_s, device_total_s (a root span on one thread counts
    towards the span of another thread that holds its start), idle_s and
    attrs."""
    clock = clock_offset(events, marks)
    off, lo, hi = clock["offset_us"], clock.pop("lo_us"), clock.pop("hi_us")
    _, anchor_ids = anchor_events(events)
    ids = {s["id"]: s for s in spans}
    intervals = sorted(((s["start_ns"] / 1e3 + off, s["end_ns"] / 1e3 + off, s) for s in spans),
                       key=lambda iv: (iv[0], iv[2]["id"]))
    adopted = _adopters(intervals)
    launches = {_args(e)["correlation"]: (e["ts"], e.get("tid")) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in _args(e)}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and id(e) not in anchor_ids]

    by_span: dict = {}

    def entry(name):
        return by_span.setdefault(name, {"count": 0, "host_s": 0.0, "device_n": 0,
                                         "device_self_s": 0.0, "device_total_s": 0.0,
                                         "idle_s": 0.0, "attrs": {}})

    for s in spans:
        row = entry(s["name"])
        row["count"] += 1
        row["host_s"] += (s["end_ns"] - s["start_ns"]) * 1e-9
        for k, v in s["attrs"].items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                old = row["attrs"].get(k)
                row["attrs"][k] = v if old is None else (max(old, v) if k.endswith("_max")
                                                         else old + v)

    launched = [(e, launches.get(_args(e).get("correlation"))) for e in dev]
    found = [(e, at) for e, at in launched if at is not None]
    unattributed = sum(e["dur"] for e, at in launched if at is None) * 1e-6
    for (e, _), s in zip(found, _holders(intervals, [at for _, at in found])):
        if s is None:
            unattributed += e["dur"] * 1e-6
            continue
        entry(s["name"])["device_self_s"] += e["dur"] * 1e-6
        entry(s["name"])["device_n"] += 1
        names, visited = set(), set()
        while s is not None and s["id"] not in visited:
            visited.add(s["id"])
            if s["name"] not in names:
                names.add(s["name"])
                entry(s["name"])["device_total_s"] += e["dur"] * 1e-6
            s = ids.get(s["parent"]) if s["parent"] is not None else adopted.get(s["id"])

    busy = []
    for start, end in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    gaps, cursor = [], lo
    for start, end in busy:
        if start > cursor:
            gaps.append((cursor, min(start, hi)))
        cursor = max(cursor, end)
    if hi > cursor:
        gaps.append((cursor, hi))
    gaps = [(a, b) for a, b in gaps if b > a]
    idle = 0.0
    for (a, b), s in zip(gaps, _innermost(intervals, [a for a, _ in gaps])):
        idle += (b - a) * 1e-6
        if s is not None:
            entry(s["name"])["idle_s"] += (b - a) * 1e-6
    return {**clock, "window_s": (hi - lo) * 1e-6, "device_s": sum(e["dur"] for e in dev) * 1e-6,
            "idle_s": idle, "unattributed_s": unattributed, "spans": len(spans),
            "by_span": by_span}


class ProgramWindow(Profiled):
    """``with ProgramWindow(device) as w: ...`` traces the block with device
    operations alone, as ``Profiled(device, host_ops=False)`` does, with the
    program's tracing on and a clock anchor at each end; after it,
    ``w.summary`` is ``Profiled``'s (of the trace without the anchors) and
    ``w.program`` the join, or None where the program has no tracing."""

    def __init__(self, device: str):
        super().__init__(device, host_ops=False)
        self.tracing = program_tracing()
        self.anchors = Anchors(device)
        self.program = None

    def __enter__(self):
        if self.tracing is not None:
            self.tracing.drain()
            self.tracing.enable()
        super().__enter__()
        self.anchors.mark()
        return self

    def __exit__(self, *exc):
        try:
            if exc[0] is not None:
                self._prof.__exit__(*exc)
                return False
            self.anchors.mark()
            self._sync()
            window_s = time.perf_counter() - self._t0
            self._prof.__exit__(None, None, None)
            with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
                path = os.path.join(tmp, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            self._prof = None
            _, anchor_ids = anchor_events(events)
            self.summary = reduce_trace([e for e in events if id(e) not in anchor_ids], window_s)
            if self.tracing is not None:
                self.program = join(events, self.tracing.drain(), self.anchors.marks)
            return False
        finally:
            if self.tracing is not None:
                self.tracing.disable()


@contextlib.contextmanager
def program_spans():
    """The program's tracing on for the block (its spans are then ranges in
    a profiler's trace), its spans dropped after; nothing without it."""
    tracing = program_tracing()
    if tracing is None:
        yield
        return
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


def run_window(next_unit, seconds: float, trace: bool, device: str, n_profiled: int,
               min_units: int = 1, before_steady=None):
    """``window.run_window``, its device-only units traced by ``ProgramWindow``
    (their join under the summary's ``"program"``) and its host-op unit with
    the program's spans on, so that its idle gaps are named by them."""
    units, summary = [], None
    start = time.perf_counter()
    if trace:
        with ProgramWindow(device) as dev:
            for _ in range(n_profiled):
                units.append(dict(next_unit(), profiled=True))
        with program_spans(), Profiled(device, host_ops=True) as host:
            units.append(dict(next_unit(), profiled=True))
        summary = dict(dev.summary, idle_gaps=host.summary["idle_gaps"])
        if dev.program is not None:
            summary["program"] = dev.program
        min_units = max(min_units, len(units) + window.STEADY_TRACED)
        if before_steady is not None:
            before_steady()
    while len(units) < min_units or units[-1]["end"] - start < seconds:
        units.append(next_unit())
    return start, units, summary


def program_of(run: dict) -> dict | None:
    """The join of a traced run's record, or None."""
    return (run.get("trace") or {}).get("program")


def span_stat(program: dict, name: str, key: str) -> float:
    """A span name's ``key`` in the join (0 where the span never ran)."""
    return program["by_span"].get(name, {}).get(key, 0.0)


def span_attr(program: dict, name: str, attr: str) -> float:
    return program["by_span"].get(name, {}).get("attrs", {}).get(attr, 0.0)
