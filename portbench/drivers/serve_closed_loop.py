"""A serving cell: a closed loop of clients through ``BatchAccumulator`` and
``ServeEngine.generate``.

Set-up draws the weights, builds the engine and serves one warm-up round at
the traffic's own shapes (a prefill at the round's padded width, two decode
steps).  In the window every client sends its next prompt as soon as its
reply is complete; the accumulator batches the pending prompts, and the batch
in flight at the close is finished and counted.  A CUDA event after each
prefill and each decode step marks when a token's logits were ready on the
device; the gaps between a request's consecutive marks are its token gaps.
After the window the reference computes, in float32, the logits from which
every served token of one batch was chosen (round 0 or 1, drawn from the
seed; every round holds the longest prompt), and the check holds the
program's tokens and the logits it chose them from (copied to the host as
they were produced) against them.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np

from portbench.harness import bench, bounds, flops, weights
from portbench.harness.window import run_window, span

PROFILE_UNITS = 2  # whole batches a traced run traces with device operations alone


class _Marks:
    """Marks after each prefill and decode step of the current batch: CUDA
    events on the card, host-clock readings (after a synchronise) on the CPU."""

    def __init__(self, device: str):
        import torch

        self.torch, self.cuda = torch, device == "cuda"
        self.batches: list[list] = []

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.batches[-1].append(ev)
        else:
            self.batches[-1].append(time.perf_counter())

    def gaps_ms(self, i: int) -> list[float]:
        ms = self.batches[i]
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(ms, ms[1:])]
        return [1e3 * (b - a) for a, b in zip(ms, ms[1:])]


class _Kept:
    """Host buffers, made in set-up, for what the checked round produces: the
    logits each served token was chosen from, and each MoE call's choices and
    placed slots (the prefill's layers, then each decode step's).  The copies
    are queued on the stream into pinned memory as the round runs, so they
    cost the host one call each and no wait."""

    def __init__(self, cfg, prompts: list, n_new: int, device: str):
        import torch

        self.torch = torch
        pin = device == "cuda"
        B, W = len(prompts), max(len(p) for p in prompts)
        self.logits = torch.empty((n_new, B, cfg.vocab_size), pin_memory=pin,
                                  dtype=getattr(torch, cfg.compute_dtype))
        self.n_logits = self.n_calls = self.bad_calls = 0
        self.n_layers = cfg.n_layers
        self.expected_calls = 0
        if cfg.moe is not None:
            k, E, L = cfg.moe.top_k, cfg.moe.n_experts, cfg.n_layers
            self.expected_calls = L * n_new  # the prefill's layers, then n_new - 1 steps'
            self.n_experts = E
            self.pre = (torch.empty((L, B * W, k), dtype=torch.long, pin_memory=pin),
                        torch.empty((L, B * W, E), dtype=torch.bool, pin_memory=pin))
            self.dec = (torch.empty((L * (n_new - 1), B, k), dtype=torch.long, pin_memory=pin),
                        torch.empty((L * (n_new - 1), B, E), dtype=torch.bool, pin_memory=pin))

    def add_logits(self, t) -> None:
        self.logits[self.n_logits].copy_(t, non_blocking=True)
        self.n_logits += 1

    def add_call(self, choice, dispatch) -> None:
        """One MoE call's choices [G, T, k] and dispatch [G, T, E, C] bool (a
        token's slots at each expert); a call of another layout, or past the
        calls expected, is counted in ``bad_calls`` and not kept."""
        i, L = self.n_calls, self.n_layers
        self.n_calls += 1
        buf, j = (self.pre, i) if i < L else (self.dec, i - L)
        G, T = choice.shape[:2]
        rows = buf[0].shape[1]
        if (i >= self.expected_calls or dispatch.dtype != self.torch.bool or dispatch.dim() != 4
                or dispatch.shape[:3] != (G, T, self.n_experts) or G * T != rows):
            self.bad_calls += 1
            return
        buf[0][j].copy_(choice.reshape(rows, -1), non_blocking=True)
        buf[1][j].copy_(dispatch.any(-1).reshape(rows, -1), non_blocking=True)

    def calls_off(self) -> int:
        """How far the MoE calls the checked round made depart from one a
        layer for its prefill and for each decode step, in that layout."""
        return abs(self.n_calls - self.expected_calls) + self.bad_calls

    def calls(self) -> list:
        L = self.n_layers
        return [(self.pre[0][i], self.pre[1][i]) for i in range(L)] + \
               [(self.dec[0][i], self.dec[1][i]) for i in range(len(self.dec[0]))]


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, control: bool = False) -> dict:
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe as port_moe
    from repro_torch.models.model import Model, param_shapes
    from repro_torch.serve.engine import BatchAccumulator, ServeEngine

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    spec, mix, cfg_file = cell.spec, cell.traffic, cell.config
    cfg = bench.model_config(cfg_file, spec["route"])
    loop = bench.traffic_generator(cell, cfg.vocab_size, seed)
    new = loop.new_tokens
    model = Model(cfg)
    params = weights.draw(param_shapes(cfg), seed, device)
    engine = ServeEngine(model, params, max_len=int(mix["prompt_max"]) + new, greedy=True,
                         device=device)
    accum = BatchAccumulator(engine, max_batch=int(spec["max_batch"]),
                             pad_token=int(mix["pad_token"]))

    marks = _Marks(device)
    current: dict = {}  # the unit in flight's host-clock spans
    real_prefill, real_decode = model.prefill, model.decode_step
    timing = {"on": False}
    # the batch to check: round 0 or 1, drawn from the seed; every round holds
    # the longest prompt.  Its logits go to the host as they are produced.
    check_round = random.Random(seed).randrange(2)
    kept = _Kept(cfg, loop.round(check_round), new, device)
    active = {"round": None}

    # the routing the checked round took: each MoE call's top-k choices (the
    # same torch.topk of the same router logits) and the slots it placed
    real_dispatch = port_moe.top_k_dispatch

    def dispatch(logits, moe_cfg, capacity):
        out = real_dispatch(logits, moe_cfg, capacity)
        if active["round"] == check_round:
            kept.add_call(torch.topk(logits, moe_cfg.moe.top_k, dim=-1).indices, out[0])
        return out

    def timed(fn, name):
        def call(*args, **kw):
            with span(name, timing["on"]):
                if timing["on"]:
                    sync()
                    t = time.perf_counter()
                out = fn(*args, **kw)
                marks.mark()
                if active["round"] == check_round:
                    kept.add_logits(out[0][:, -1])
                if timing["on"]:
                    sync()
                    current[name].append(time.perf_counter() - t)
                return out
        return call

    # the model is this run's own object: its wrapped methods go with it
    model.prefill, model.decode_step = timed(real_prefill, "prefill"), timed(real_decode, "decode")
    port_moe.top_k_dispatch = dispatch

    def serve(k: int, prompts: list, max_new: int) -> dict:
        active["round"] = k
        current.clear()
        current.update(prefill=[], decode=[])
        marks.batches.append([])
        start = time.perf_counter()
        for p in prompts:
            accum.submit(p)
        results = accum.flush(max_new_tokens=max_new)
        return {"start": start, "end": time.perf_counter(), "prompts": prompts, "round": k,
                "tokens": [np.asarray(r["tokens"]) for r in results], **current}

    serve(-1, loop.warmup_round(), 3)
    sync()
    marks.batches.clear()

    rounds = iter(range(1 << 62))
    launches0 = fa.flash_attention.launches
    setup_s = time.perf_counter() - t0

    def next_round():
        k = next(rounds)
        return serve(k, loop.round(k), new)

    try:
        window_start, units, summary = run_window(
            next_round, seconds, trace, device, PROFILE_UNITS, min_units=check_round + 1,
            before_steady=lambda: timing.update(on=True))
        sync()
    finally:
        port_moe.top_k_dispatch = real_dispatch
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    flash_launches = fa.flash_attention.launches - launches0

    gaps = []
    for i, u in enumerate(units):
        gaps += marks.gaps_ms(i) * len(u["prompts"])
    ok = [u for u in units if all(len(t) == new for t in u["tokens"])]
    steady = [u for u in units if not u.get("profiled")]
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    flash_bound = 0.0
    for u in units[:PROFILE_UNITS] if trace and cfg.attention_impl == "flash" else []:
        W = max(len(p) for p in u["prompts"])
        flash_bound += cfg.n_layers * bounds.attention_bound_s(
            cfg.compute_dtype, len(u["prompts"]), W, W, H, K, D, True, cfg.sliding_window)[0]
    record = {
        "setup_s": setup_s,
        "window_s": units[-1]["end"] - window_start,
        "tokens": sum(sum(len(p) for p in u["prompts"]) + new * len(u["prompts"]) for u in ok),
        "token_gaps_ms": gaps,
        "units": len(units),
        "unit_s": [u["end"] - u["start"] for u in units],
        "steady_s": sum(u["end"] - u["start"] for u in steady),
        "model_flops_steady": sum(flops.request_flops(cfg_file, len(p), new)
                                  for u in steady for p in u["prompts"]),
        "prefill_s": [s for u in steady for s in u["prefill"]],
        "decode_s": [s for u in steady for s in u["decode"]],
        "flash_launches": flash_launches,
        # the kernel runs on the card only; on the CPU its plain version does
        "flash_launches_expected": (cfg.n_layers * len(units)
                                    if cfg.attention_impl == "flash" and device == "cuda" else 0),
        "flash_bound_s": flash_bound,
        "trace": summary,
    }
    attempted = sum(len(u["prompts"]) for u in units)
    failed = attempted - sum(len(u["prompts"]) for u in ok)

    checked = units[check_round]
    program_logits = kept.logits.transpose(0, 1)  # [B, n, V]
    # free the program's state, weights included, then draw the reference's
    # own weights from the seed
    del engine, accum, marks, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    params = weights.draw(param_shapes(cfg), seed, device)
    from portbench.reference import model as M
    from portbench.reference import serve as ref_serve
    from portbench.reference.compare import serve_numbers

    M.no_tf32()
    served_tokens = torch.as_tensor(np.stack(checked["tokens"]))
    pad = int(mix["pad_token"])
    W = max(len(p) for p in checked["prompts"])
    tape = (ref_serve.tape_of_calls(kept.calls(), len(checked["prompts"]), W, new, cfg.n_layers)
            if cfg.moe is not None else None)

    def judge_side(chosen, logits, side_tape):
        """The numbers of one side (the program, or a stand-in in its place,
        fed the program's tokens) against the f32 reference following that
        side's routing."""
        ref, routing = ref_serve.served_logits(params, cfg_file, checked["prompts"],
                                               served_tokens, pad, M.Precision("float32"),
                                               side_tape)
        out = serve_numbers(ref, chosen, logits)
        if routing is not None:
            out.update(route_margin=max(routing.margins), slots_off=float(routing.mismatches),
                       route_choices_off=routing.off_choices / max(routing.n_choices, 1))
        return out

    numbers = judge_side(served_tokens, program_logits, tape)
    extra = {}
    if control:
        extra["program"] = dict(numbers)
        for name, prec in (("control", "float8"), ("bf16_witness", "bfloat16")):
            low, routing = ref_serve.served_logits(params, cfg_file, checked["prompts"],
                                                   served_tokens, pad, M.Precision(prec))
            extra[name] = judge_side(low.argmax(-1), low, routing.record if routing else None)
            del low, routing
    route_ok = flash_launches == record["flash_launches_expected"]
    numbers["route_launches_off"] = 0.0 if route_ok else 1.0
    numbers["route_calls_off"] = float(kept.calls_off())
    ok_all, checks = bench.judge(numbers, dict(spec["limits"], route_launches_off=0.0,
                                               route_calls_off=0.0))
    return {"record": record, "correct": ok_all, "checks": checks, "attempted": attempted,
            "failed": failed, "memory_peak_bytes": memory_peak, "readings": extra}
