"""A training cell: the paper's training use case on the port's control plane.

Set-up builds one ``TrainingFabric`` (model, AdamW state, the mix's token
stream), puts the benchmark's weights into it, publishes a one-state flow
whose action runs the registered ``train_steps`` through ``ap://compute``, and
runs the flow once to warm every shape up.  It then sets that same fabric
back to step 0 (the weights drawn again in place, m and v zeroed, the token
stream rewound), so that the window's first flow run takes the program's
first steps again: those are the steps the check reads.  The window runs the
flow back to back, the run in flight at the close finished and counted.
After the window the program's state is freed and the reference takes the
first three steps from the same weights and batches, in float32.
"""

from __future__ import annotations

import gc
import itertools
import os
import tempfile
import time

from portbench.harness import bench, flops, weights
from portbench.harness.window import run_window, span

N_CHECKED = 3  # steps the reference follows
PROFILE_UNITS = 1  # whole flow runs a traced run traces with device operations alone


def _flow(eid: str, fid: str) -> dict:
    return {"Comment": "train in a bounded segment", "StartAt": "Train", "States": {
        "Train": {"Type": "Action", "ActionUrl": "ap://compute",
                  "Parameters": {"endpoint_id": eid, "function_id": fid, "kwargs": {}},
                  "ResultPath": "$.train", "WaitTime": 3600, "End": True}}}


def _named(tree) -> dict:
    return {"/".join(path): t for path, t in weights.leaves(tree)}


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, control: bool = False) -> dict:
    import torch

    import repro_torch.train.optimizer as optmod
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.actions import ActionRegistry
    from repro_torch.core.clock import RealClock
    from repro_torch.core.engine import PollingPolicy
    from repro_torch.core.flows_service import FlowsService
    from repro_torch.core.providers import ComputeProvider
    from repro_torch.models.model import param_shapes
    from repro_torch.train.fabric import TrainingFabric

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    spec, mix, cfg_file = cell.spec, cell.traffic, cell.config
    cfg = bench.model_config(cfg_file, spec["route"])
    tcfg = TrainConfig(**spec["train"])
    data = bench.traffic_generator(cell, cfg.vocab_size, seed)
    n_steps = int(mix["steps_per_flow"])
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")  # the flow writes no checkpoint
    fabric = TrainingFabric(cfg, tcfg, batch=data.batch, seq_len=data.seq,
                            ckpt_dir=os.path.join(tmp.name, "ckpt"), data=data, seed=seed,
                            device=device)
    shapes = param_shapes(cfg)
    weights.draw_into(fabric.state.params, seed)

    registry = ActionRegistry()
    compute = ComputeProvider(clock=RealClock())
    registry.register(compute)
    flows = FlowsService(registry, clock=RealClock(), polling=PollingPolicy(
        initial_seconds=0.02, cap_seconds=0.5, use_callbacks=True))
    train_steps = fabric.train_steps
    current: dict = {}  # the unit in flight's host-clock spans

    def timed_train_steps(**_):
        with span("train_steps", trace):
            t = time.perf_counter()
            try:
                return train_steps(n_steps=n_steps)
            finally:
                current["train_steps"] = time.perf_counter() - t

    eid = compute.register_endpoint("training-fabric", mode="inline")
    fid = compute.register_function(timed_train_steps, name="train_steps")
    flow_id = flows.publish_flow(_flow(eid, fid), input_schema={"type": "object"},
                                 title=f"Train {cfg.arch}").flow_id

    def one_flow():
        current.clear()
        current["adamw"] = []
        start = time.perf_counter()
        with span("flow_run", trace):
            run = flows.run_flow(flow_id, {})
            flows.engine.wait(run.run_id, timeout=3600)
        return {"start": start, "end": time.perf_counter(), "ok": run.status == "SUCCEEDED",
                **current}

    # The probes read the program's first steps as the optimizer gets them:
    # each step's loss, the first gradient's norm (from m after one step) and
    # the change after three steps, kept on the device until the window has
    # closed.  They run in the warm-up flow run (so that the window's first
    # run makes no allocation the warm-up did not) and in the window's first
    # flow run, whose readings the check compares.
    probe: dict = {"on": False}
    real_adamw, real_loss = optmod.adamw_update, fabric.model.loss
    timing = {"on": False}  # the adamw span: steady units of a traced run

    def arm():
        probe.clear()
        probe.update(on=True, losses=[], updates=0)

    def loss_hook(params, batch):
        loss = real_loss(params, batch)
        if probe["on"]:
            probe["losses"].append(loss.detach())
        return loss

    def adamw_hook(params, grads, state, tc):
        if not timing["on"]:
            out = real_adamw(params, grads, state, tc)
        else:
            with span("adamw_update", True):
                sync()
                t = time.perf_counter()
                out = real_adamw(params, grads, state, tc)
                sync()
                current["adamw"].append(time.perf_counter() - t)
        if probe["on"]:
            probe["updates"] += 1
            with torch.no_grad():
                if probe["updates"] == 1:
                    probe["grad_norms"] = {k: torch.linalg.vector_norm(m) / (1 - tc.beta1)
                                           for k, m in _named(out[1].m).items()}
                if probe["updates"] == N_CHECKED:
                    p0 = _named(weights.draw(shapes, seed, device))
                    probe["change_norms"] = {k: torch.linalg.vector_norm(p - p0[k])
                                             for k, p in _named(params).items()}
                    del p0
                    probe["on"] = False
        return out

    def reset():
        """The fabric back at step 0: the weights drawn again from the seed,
        in place, m and v zeroed, the step 0, the token stream rewound."""
        state = fabric.state
        with torch.no_grad():
            weights.draw_into(state.params, seed)
            for _, t in weights.leaves(state.opt.m):
                t.zero_()
            for _, t in weights.leaves(state.opt.v):
                t.zero_()
            state.opt.step.zero_()
        data.rewind()

    n_units = itertools.count()

    def window_unit():
        if next(n_units) == 0:
            arm()
        return one_flow()

    fabric.model.loss, optmod.adamw_update = loss_hook, adamw_hook
    try:
        arm()
        one_flow()  # warm-up: every shape the window runs
        reset()
        sync()
        setup_s = time.perf_counter() - t0
        window_start, units, summary = run_window(
            window_unit, seconds, trace, device, PROFILE_UNITS,
            before_steady=lambda: timing.update(on=True))
    finally:
        optmod.adamw_update = real_adamw
        del fabric.model.loss
    program = {"losses": [float(x) for x in probe["losses"][:N_CHECKED]],
               "grad_norms": {k: float(v) for k, v in probe.get("grad_norms", {}).items()},
               "change_norms": {k: float(v) for k, v in probe.get("change_norms", {}).items()}}
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    ok_units = [u for u in units if u["ok"]]
    steady = [u for u in ok_units if not u.get("profiled")]
    step_flops = flops.train_step_flops(cfg_file, data.batch, data.seq)
    record = {
        "setup_s": setup_s,
        "window_s": units[-1]["end"] - window_start,
        "tokens": n_steps * data.batch * data.seq * len(ok_units),
        "units": len(units),
        "unit_s": [u["end"] - u["start"] for u in units],
        "steady_s": sum(u["end"] - u["start"] for u in steady),
        "steady_span_s": sum(u["train_steps"] for u in steady),
        "model_flops_steady": step_flops * n_steps * len(steady),
        "adamw_s": [s for u in steady for s in u["adamw"]],
        "trace": summary,
    }
    attempted, failed = len(units), len(units) - len(ok_units)

    # free the program's state, then the reference's three steps
    flows.engine.shutdown()
    tmp.cleanup()
    fabric.state = None
    del fabric, flows, compute, registry
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    from portbench.reference import model as M
    from portbench.reference import train as ref_train
    from portbench.reference.compare import train_numbers

    M.no_tf32()
    params0 = weights.draw(shapes, seed, device)
    batches = [data.batch_at(i) for i in range(N_CHECKED)]
    tdict = spec["train"]
    ref = ref_train.follow(params0, cfg_file, tdict, batches, N_CHECKED, M.Precision("float32"))
    numbers = train_numbers(program, ref) if program["change_norms"] else {}
    extra = {}
    if control:
        ctrl = ref_train.follow(params0, cfg_file, tdict, batches, N_CHECKED,
                                M.Precision("float8"))
        half = ref_train.follow(params0, cfg_file, tdict, batches, N_CHECKED,
                                M.Precision("float32"), rows=slice(0, data.batch // 2))
        extra = {"program": numbers, "control": train_numbers(ctrl, ref),
                 "half_batch": train_numbers(half, ref)}
    ok, checks = bench.judge(numbers, spec["limits"])
    return {"record": record, "correct": ok, "checks": checks, "attempted": attempted,
            "failed": failed, "memory_peak_bytes": memory_peak, "readings": extra}
