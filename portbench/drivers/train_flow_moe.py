"""A training cell for a latent-attention mixture-of-experts model
(DeepSeek-V3's block): ``train_flow``'s flow, window and check, with what the
model adds.

Set-up builds one ``TrainingFabric``, puts the benchmark's weights into it,
publishes the one-state flow whose action runs the registered
``train_steps`` through ``ap://compute``, runs it once to warm every shape up,
then sets that fabric back to step 0 in place (the weights drawn again, m, v
and the routers' correction biases zeroed, the token stream rewound).  The
window runs the flow back to back through ``portbench.harness.spans``'s
window, so that a traced run joins the program's spans.

The check reads the window's first flow run, every step of it: each step's
loss, the first gradient's norm (from m after one step), the change after
the steps, the biases after their updates, and each MoE call's choices in
each step's forward (``repro_torch.models.moe.select_experts``, the calls a
remat's recompute makes again left out).  After the window the program's
state is freed and the reference (``portbench/reference/deepseek_v3.py``)
takes the same steps from the same weights and batches in float32,
following the program's routing, and checks that routing apart.
"""

from __future__ import annotations

import gc
import itertools
import os
import tempfile
import time

from portbench.drivers.train_flow import _flow, _named
from portbench.harness import bench, flops_mla_moe, weights
from portbench.harness.spans import run_window
from portbench.harness.window import span

PROFILE_UNITS = 1  # whole flow runs a traced run traces with device operations alone


def _numbers(program: dict, ref: dict) -> dict:
    """The train numbers, the routing's and the biases' of one side against
    the reference that followed its routing."""
    from portbench.reference.compare import train_numbers

    out = train_numbers(program, ref)
    out["route_margin"] = max(ref["margins"])
    out["route_choices_off"] = ref["off_choices"] / max(ref["n_choices"], 1)
    out["bias_off"] = float((program["bias"].to(ref["bias"].device) != ref["bias"]).sum())
    return out


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
    from repro_torch.models import moe as port_moe
    from repro_torch.models.model import param_shapes
    from repro_torch.train.fabric import TrainingFabric

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    spec, mix, cfg_file = cell.spec, cell.traffic, cell.config
    cfg = bench.model_config(cfg_file, spec["route"])
    tcfg = TrainConfig(**spec["train"])
    data = bench.traffic_generator(cell, cfg.vocab_size, seed)
    n_steps = int(mix["steps_per_flow"])
    n_moe = cfg.n_layers - cfg.first_dense_layers
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

    # The probes read the program's steps as they run, kept on the device
    # until the window has closed: each step's loss and its forward's MoE
    # choices, the first gradient's norm (from m after one step), the change
    # and the biases after the steps.  They run in the warm-up flow run (so
    # that the window's first run makes no allocation the warm-up did not)
    # and in the window's first flow run, whose readings the check compares.
    probe: dict = {"on": False}
    real_adamw, real_loss = optmod.adamw_update, fabric.model.loss
    real_select, real_update = port_moe.select_experts, port_moe.Balance.update_
    timing = {"on": False}  # the adamw span: steady units of a traced run

    def arm():
        probe.clear()
        probe.update(on=True, losses=[], updates=0, forward=False, tapes=[])

    def loss_hook(params, batch, *rest):
        if probe["on"]:
            probe["forward"] = True
            probe["tapes"].append([])
        try:
            loss = real_loss(params, batch, *rest)
        finally:
            probe["forward"] = False
        if probe["on"]:
            probe["losses"].append(loss.detach())
        return loss

    def select_hook(logits, moe_cfg, bias=None):
        out = real_select(logits, moe_cfg, bias)
        if probe["on"] and probe["forward"]:
            probe["tapes"][-1].append(out[0].to(torch.uint8))
        return out

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
                if probe["updates"] == n_steps:
                    p0 = _named(weights.draw(shapes, seed, device))
                    probe["change_norms"] = {k: torch.linalg.vector_norm(p - p0[k])
                                             for k, p in _named(params).items()}
                    del p0
        return out

    def update_hook(self, gamma):
        real_update(self, gamma)
        if probe["on"] and probe["updates"] == n_steps:
            probe["bias"] = self.bias.clone()
            probe["on"] = False

    def reset():
        """The fabric back at step 0: the weights drawn again from the seed,
        in place, m, v and the biases zeroed, the step 0, the stream rewound."""
        state = fabric.state
        with torch.no_grad():
            weights.draw_into(state.params, seed)
            for tree in (state.opt.m, state.opt.v, state.buffers):
                for _, t in weights.leaves(tree):
                    t.zero_()
            state.opt.step.zero_()
        data.rewind()

    n_units = itertools.count()

    def window_unit():
        if next(n_units) == 0:
            arm()
        return one_flow()

    fabric.model.loss, optmod.adamw_update = loss_hook, adamw_hook
    port_moe.select_experts, port_moe.Balance.update_ = select_hook, update_hook
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
        port_moe.select_experts, port_moe.Balance.update_ = real_select, real_update
        del fabric.model.loss
    tapes = [t for t in probe["tapes"] if len(t) == n_moe][:n_steps]
    program = {"losses": [float(x) for x in probe["losses"][:n_steps]],
               "grad_norms": {k: float(v) for k, v in probe.get("grad_norms", {}).items()},
               "change_norms": {k: float(v) for k, v in probe.get("change_norms", {}).items()},
               "bias": probe.get("bias")}
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    ok_units = [u for u in units if u["ok"]]
    steady = [u for u in ok_units if not u.get("profiled")]
    step_flops = flops_mla_moe.train_step_flops(cfg_file, data.batch, data.seq)
    record = {
        "setup_s": setup_s,
        "window_s": units[-1]["end"] - window_start,
        "tokens": n_steps * data.batch * data.seq * len(ok_units),
        "units": len(units),
        "unit_s": [u["end"] - u["start"] for u in units],
        "steady_s": sum(u["end"] - u["start"] for u in steady),
        "steady_span_s": sum(u["train_steps"] for u in steady),
        "mla_moe_flops_steady": step_flops * n_steps * len(steady),
        "adamw_s": [s for u in steady for s in u["adamw"]],
        "trace": summary,
    }
    attempted, failed = len(units), len(units) - len(ok_units)

    # free the program's state, then the reference's steps
    flows.engine.shutdown()
    tmp.cleanup()
    fabric.state = None
    del fabric, flows, compute, registry
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    from portbench.reference import deepseek_v3 as R
    from portbench.reference import model as M
    from portbench.reference.compare import train_numbers

    M.no_tf32()
    params0 = weights.draw(shapes, seed, device)
    batches = [data.batch_at(i) for i in range(n_steps)]
    tdict = spec["train"]
    # the routing the program took, if every step's forward left one call a MoE layer
    complete = (len(tapes) == n_steps and program["bias"] is not None
                and bool(program["change_norms"]))
    numbers, ref = {}, None
    if complete:
        ref = R.follow(params0, cfg_file, tdict, batches, n_steps, M.Precision("float32"), tapes)
        numbers = _numbers(program, ref)
    extra = {}
    if control and ref is not None:
        # the control routes by its own scores, and is held against the f32
        # reference that follows its routing; the half batch follows the
        # program's and is held against the program's reference
        ctrl = R.follow(params0, cfg_file, tdict, batches, n_steps, M.Precision("float8"))
        ref_c = R.follow(params0, cfg_file, tdict, batches, n_steps, M.Precision("float32"),
                         ctrl["tapes"])
        half = R.follow(params0, cfg_file, tdict, batches, n_steps, M.Precision("float32"),
                        tapes, rows=slice(0, data.batch // 2))
        extra = {"program": numbers, "control": _numbers(ctrl, ref_c),
                 "half_batch": train_numbers(half, ref)}
    ok, checks = bench.judge(numbers, spec["limits"])
    return {"record": record, "correct": ok, "checks": checks, "attempted": attempted,
            "failed": failed, "memory_peak_bytes": memory_peak, "readings": extra}
