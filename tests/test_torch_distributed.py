"""Sharded training and serving of the port over gloo, on the CPU.

Each test spawns its ranks (four unless it says otherwise), which meet
through a ``FileStore`` in the test's ``tmp_path`` (so no port is shared
under xdist), run one SPMD worker of this module and pickle its result.  A
test fails with the ranks' output when they exit non-zero or outrun its join
timeout (``TIMEOUT``, killed then), so none can hang the suite.  The
reference for each check is the single-process port (whose own tests hold it
to the JAX package):

* 2 training steps of SMOKE internlm2, mixtral, zamba2 and xlstm through
  ``TrainingFabric(mesh=(2, 2))``, and of internlm2, mixtral with 2 experts
  and xlstm on (1, 4), against the unsharded fabric on the same weights and
  batches (with 2 experts, layer 0's ``apply_moe(use_gmm=True)`` on the
  mesh too, against whole tensors): the loss at rtol = atol = 1e-5, the updated params at
  atol 2 lr(step 0) + rtol 1e-4 (after one Adam step the sign of a near-zero
  gradient is a whole +-lr, as in ``tests/test_torch_train.py``);
* the gradients' placements after the step's redistribution equal the
  params' (``grad_shardings``);
* prefill under ``"flash"`` on a (1, 4) mesh, where SMOKE internlm2's 2 kv
  heads do not divide the model axis and stay whole on every rank, against
  unsharded prefill, and one decode step after it; the kernels' entry points
  (``mamba_scan``, ``gmm``) on DTensors against whole tensors;
* SMOKE whisper-medium's prefill under ``"flash"`` (its encoder
  non-causal) on (2, 2), on (1, 4) and, with 2 heads that do not divide
  the model axis, on (1, 4), against unsharded prefill: the logits, the
  self and cross caches, and one decode step after it;
* a checkpoint saved (asynchronously) on (2, 2), restored onto (1, 2) and
  onto no mesh, bit-equal;
* ``python -m repro_torch.launch.elastic --device cpu`` ending SUCCEEDED at
  step 10 or more on the ranks that stay.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

import torch.multiprocessing as mp  # noqa: E402

TIMEOUT = 120  # seconds, each multi-process test's join timeout
WORLD = 4
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("internlm2-1.8b", "mixtral-8x7b", "zamba2-7b", "xlstm-1.3b")


# --- the harness --------------------------------------------------------------


def _rank_main(worker, rank, world, init_method, tmp, kwargs):
    log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_process_group

    init_process_group("cpu", rank, world, init_method)
    try:
        out = worker(rank, tmp, **kwargs)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def _logs(tmp) -> str:
    out = []
    for rank in range(WORLD):
        path = os.path.join(tmp, f"rank{rank}.log")
        if os.path.exists(path):
            with open(path) as fh:
                out.append(f"--- rank {rank} ---\n" + fh.read()[-4000:])
    return "\n".join(out)


def run_ranks(tmp_path, worker, timeout=TIMEOUT, **kwargs) -> list:
    """Each rank's return value of ``worker(rank, tmp, **kwargs)``, in rank order."""
    tmp = str(tmp_path)
    ctx = mp.get_context("spawn")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(worker, rank, WORLD, init_method, tmp, kwargs))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
            p.join()
        pytest.fail(f"ranks still running after {timeout} s\n{_logs(tmp)}")
    if any(p.exitcode != 0 for p in procs):
        pytest.fail(f"exit codes {[p.exitcode for p in procs]}\n{_logs(tmp)}")
    results = []
    for rank in range(WORLD):
        with open(os.path.join(tmp, f"out{rank}.pkl"), "rb") as fh:
            results.append(pickle.load(fh))
    return results


# --- workers (run in the ranks; import nothing of JAX) ------------------------


def _train_cfg():
    from repro_torch.configs.base import TrainConfig

    return TrainConfig(total_steps=10, warmup_steps=2, learning_rate=1e-3)


def _fabric(arch, tmp, mesh, name, n_experts=None):
    import dataclasses

    from repro_torch import configs
    from repro_torch.train.fabric import TrainingFabric

    cfg = configs.get(arch, smoke=True).replace(compute_dtype="float32")
    if n_experts is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=n_experts))
    return TrainingFabric(cfg, _train_cfg(), batch=4, seq_len=16,
                          ckpt_dir=os.path.join(tmp, name), device="cpu", mesh=mesh)


def _train_worker(rank, tmp, arch, shape=(2, 2), n_experts=None):
    """2 steps on ``shape`` from redrawn weights; rank 0 also runs them
    unsharded.  An MoE config also runs layer 0's ``apply_moe(use_gmm=True)``
    on the mesh against whole tensors, and reports where the rules put the
    expert FFN's hidden ``h`` [G,E,C,F] and the xLSTM's heads."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as sh
    from repro_torch.testing import redraw_params_
    from repro_torch.train import loop
    from repro_torch.train.loop import TrainState
    from repro_torch.train.optimizer import init_adamw

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    plain = _fabric(arch, tmp, None, f"plain{rank}", n_experts)
    redraw_params_(plain.state.params, 7)
    full = L.map_tree(torch.clone, plain.state.params)
    fabric = _fabric(arch, tmp, mesh, "sharded", n_experts)
    p_sh = fabric._shardings()[0]
    params = sh.distribute_tree(full, p_sh)
    fabric.state = TrainState(params, init_adamw(params))

    # the gradients' placements: as the backward leaves them, then as the
    # step puts them (grad_shardings = the params')
    batch = {k: torch.as_tensor(v) for k, v in fabric.data.batch_at(0).items()}
    with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
        mb = {k: sh.distribute_input(v, "batch", None) for k, v in batch.items()}
        _, grads = L.value_and_grad(fabric.model.loss, params, mb)
        placed = loop._place_grads(grads, params, p_sh)
    flat = lambda t: [x for _, x in L.flatten_specs(t)]  # noqa: E731
    grad_placements_match = all(
        isinstance(g, DTensor) and g.placements == p.placements == s.placements
        for g, p, s in zip(flat(placed), flat(params), flat(p_sh)))
    raw_differ = sum(g.placements != p.placements for g, p in zip(flat(grads), flat(params)))
    cfg = fabric.model.cfg
    sizes = sh.mesh_axis_sizes(mesh)
    specs = {"lstm_heads": sh.assign_spec(("lstm_heads",), (cfg.n_heads,), sh.ACT_RULES, sizes)}
    splits = _splits(cfg, mesh)
    gmm = None
    if cfg.moe is not None:
        E, F_ = cfg.moe.n_experts, cfg.moe.d_ff
        specs["h"] = sh.assign_spec(("batch", "experts", "expert_capacity", "mlp"),
                                    (4, E, 8, F_), sh.ACT_RULES, sizes)
        x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            want, want_aux = moe.apply_moe(tfm.layer_params(full["blocks"], 0)["moe"], cfg, x,
                                           use_gmm=True)
            with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
                got, aux = moe.apply_moe(tfm.layer_params(params["blocks"], 0)["moe"], cfg,
                                         sh.distribute_input(x, "batch", "seq", "embed"),
                                         use_gmm=True)
                got, aux = got.full_tensor(), sh.full_tensor(aux)
        gmm = {"out": float((got - want).abs().max()), "scale": float(want.abs().max()),
               "aux": float((aux - want_aux).abs())}

    records = [fabric.train_steps(1) for _ in range(2)]
    got = [x.full_tensor().numpy() for x in flat(fabric.state.params)]
    out = {"losses": [r["loss"] for r in records],
           "grad_norms": [r["grad_norm"] for r in records],
           "m_placements_match": all(m.placements == p.placements for m, p in
                                     zip(flat(fabric.state.opt.m), flat(fabric.state.params))),
           "grad_placements_match": grad_placements_match, "raw_differ": raw_differ,
           "n_leaves": len(got), "specs": specs, "splits": splits, "gmm": gmm}
    if rank == 0:
        want_records = [plain.train_steps(1) for _ in range(2)]
        want = [x.numpy() for x in flat(plain.state.params)]
        lr0 = float(_train_cfg().learning_rate) / 2  # lr(step 0) = lr * 1 / warmup
        out.update(
            want_losses=[r["loss"] for r in want_records],
            want_grad_norms=[r["grad_norm"] for r in want_records],
            param_excess=max(float(np.max(np.abs(g - w) - (2 * lr0 + 1e-4 * np.abs(w))))
                             for g, w in zip(got, want)))
    return out


def _splits(cfg, mesh, batch=4, seq=16) -> dict:
    """Where the mesh splits the work the reference's XLA splits and the
    rules cannot say: the mesh dims whose ranks split one routing group's
    expert work (ROADMAP F11), and the (mesh dim, ranks a head) that split
    each xLSTM mLSTM head's value dim and each sLSTM head's columns (F9,
    F14), for a [batch, seq] input."""
    from repro_torch.models import moe, xlstm
    from repro_torch.parallel import sharding as sh

    out = {}
    with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
        x = sh.distribute_input(torch.zeros(batch, seq, cfg.d_model), "batch", "seq", "embed")
        if cfg.moe is not None and moe.group_tokens(batch * seq) == 1:
            C = moe.capacity_for(batch * seq, cfg)
            hp = sh.act_placements(x.new_empty(()).expand(1, cfg.moe.n_experts, C, cfg.moe.d_ff),
                                   "batch", "experts", "expert_capacity", "mlp")
            out["moe"] = sh.untaken_axes(hp, mesh, "batch", cfg.d_model, batch)
        if cfg.xlstm is not None:
            d_inner, H, _, Vd = xlstm.mlstm_dims(cfg)
            c = sh.distribute_input(torch.zeros(batch, seq, d_inner), "batch", "seq", "lstm_inner")
            out["xlstm"] = xlstm._head_split(c.device_mesh, H, Vd)
            out["slstm"] = xlstm._head_split(c.device_mesh, *xlstm.slstm_dims(cfg))
    return out


def _tree_leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], f"{path}/{k}")
    elif tree is not None:
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{path}/{i}")


DECODE_CASES = {"mixtral-8x7b-2x2": ("mixtral-8x7b", (2, 2)),
                "xlstm-1.3b-2x2": ("xlstm-1.3b", (2, 2)),
                "xlstm-1.3b-1x4": ("xlstm-1.3b", (1, 4))}


def _decode_worker(rank, tmp):
    """Each of ``DECODE_CASES``: prefill of 16 tokens and 2 decode steps of
    SMOKE ``arch`` on the mesh, against the same unsharded: max |difference|
    of the logits and of every cache leaf, each with its scale."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model, param_axes, param_shapes
    from repro_torch.parallel import sharding as sh
    from repro_torch.testing import redraw_params_

    out = {}
    for name, (arch, shape) in DECODE_CASES.items():
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        cfg = configs.get(arch, smoke=True).replace(compute_dtype="float32")
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        redraw_params_(params, 3)
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        steps = [torch.randint(0, cfg.vocab_size, (2, 1), generator=gen) for _ in range(2)]
        with torch.inference_mode():
            want, cache = model.prefill(params, {"tokens": tokens}, 24)
            want = [want]
            for i, t in enumerate(steps):
                want.append(model.decode_step(params, t, cache, 16 + i)[0])
            dparams = sh.distribute_tree(params, sh.param_shardings(
                param_axes(cfg), mesh, sh.PARAM_RULES, param_shapes(cfg)))
            with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
                logits, dcache = model.prefill(dparams, {"tokens": sh.distribute_input(
                    tokens, "batch", "seq")}, 24)
                got = [logits]
                for i, t in enumerate(steps):
                    got.append(model.decode_step(dparams, sh.distribute_input(t, "batch", "seq"),
                                                 dcache, 16 + i)[0])
                got = [g.full_tensor() for g in got]
                got_cache = {p: sh.full_tensor(t) for p, t in _tree_leaves(dcache)}
        out[name] = {
            "splits": _splits(cfg, mesh, 2, 1),
            "logits": [(float((g - w).abs().max()), float(w.abs().max()))
                       for g, w in zip(got, want)],
            "cache": {p: (float((got_cache[p] - t).abs().max()), float(t.abs().max()))
                      for p, t in _tree_leaves(cache)}}
    return out


def _slstm_split_worker(rank, tmp):
    """The sLSTM's recurrence split over each head's ranks (2 heads on a
    (1, 4) mesh, each head's 8 columns over 2 ranks, ``xlstm._slstm_value_split``)
    against the unsplit op on whole tensors: h and the final state, and the
    gradients of a weighted sum of them with respect to wx, R and the
    initial state.  Max |difference| and the scale of each."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import xlstm
    from repro_torch.parallel import sharding as sh

    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    B, S, H, dh = 2, 9, 2, 8
    rng = np.random.default_rng(4)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    wx = [f(B, S, H * dh) for _ in range(4)]
    R = [0.5 * f(H, dh, dh) for _ in range(4)]
    state = [f(B, H, dh), f(B, H, dh), f(B, H, dh).abs() + 0.5, f(B, H, dh)]
    weights = [f(B, S, H * dh)] + [f(B, H, dh) for _ in range(4)]

    def loss(outs):
        return sum((o * w).sum() for o, w in zip(outs, weights))

    leaves = [t.clone().requires_grad_() for t in (*wx, *R, *state)]
    stacks = xlstm.slstm_scan(tuple(t.reshape(B, S, H, dh) for t in leaves[:4]),
                              tuple(leaves[4:8]), tuple(leaves[8:]))
    want = [stacks[0].reshape(B, S, H * dh), *(st[:, -1] for st in stacks)]
    want += torch.autograd.grad(loss(want), leaves)
    with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
        split = xlstm._head_split(mesh, H, dh)
        dleaves = ([sh.distribute_input(t, "batch", "seq", "lstm_inner") for t in wx]
                   + [sh.replicated(t, mesh) for t in R]
                   + [sh.distribute_input(t, "batch", "lstm_heads", None) for t in state])
        dleaves = [t.requires_grad_() for t in dleaves]
        h, final = xlstm._slstm_value_split(tuple(dleaves[:4]), tuple(dleaves[4:8]),
                                            tuple(dleaves[8:]), split, True)
        got = [h, *final]
        got += torch.autograd.grad(loss(got).full_tensor(), dleaves)
        got = [t.full_tensor() for t in got]
    return {"split": split,
            "diffs": [(float((g - w).abs().max()), float(w.abs().max()))
                      for g, w in zip(got, want)]}


def _prefill_worker(rank, tmp):
    """Flash prefill and one decode step of SMOKE internlm2 on (1, 4)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model, param_axes, param_shapes
    from repro_torch.parallel import sharding as sh
    from repro_torch.testing import redraw_params_

    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    cfg = configs.get("internlm2-1.8b", smoke=True).replace(
        compute_dtype="float32", attention_impl="flash")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    redraw_params_(params, 3)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
    kv_spec = sh.assign_spec(("batch", "kv_seq", "kv_heads", "head_dim"),
                             (2, 24, cfg.n_kv_heads, cfg.resolved_head_dim),
                             sh.ACT_RULES, sh.mesh_axis_sizes(mesh))
    with torch.inference_mode():
        want, cache = model.prefill(params, {"tokens": tokens}, 24)
        want_dec, _ = model.decode_step(params, nxt, cache, 16)
        dparams = sh.distribute_tree(params, sh.param_shardings(
            param_axes(cfg), mesh, sh.PARAM_RULES, param_shapes(cfg)))
        with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
            got, dcache = model.prefill(dparams, {"tokens": sh.distribute_input(
                tokens, "batch", "seq")}, 24)
            got_k = dcache["k"].full_tensor()
            dec, _ = model.decode_step(dparams, sh.distribute_input(nxt, "batch", "seq"),
                                       dcache, 16)
            got, dec = got.full_tensor(), dec.full_tensor()
        entry = _entry_points_on(mesh)
    return {"heads": (cfg.n_heads, cfg.n_kv_heads), "kv_spec": kv_spec, "entry": entry,
            "logits": float((got - want).abs().max()),
            "scale": float(want.abs().max()),
            "cache": float((got_k - cache["k"]).abs().max()),
            "decode": float((dec - want_dec).abs().max())}


def _whisper_prefill_worker(rank, tmp):
    """Flash prefill and one decode step of SMOKE whisper-medium on (2, 2),
    on (1, 4) and, with 2 heads, on (1, 4): max |difference| from unsharded."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model, param_axes, param_shapes
    from repro_torch.parallel import sharding as sh
    from repro_torch.testing import redraw_params_

    out = {}
    smoke = configs.get("whisper-medium", smoke=True).replace(
        compute_dtype="float32", attention_impl="flash")
    cases = {"2x2": ((2, 2), smoke), "1x4": ((1, 4), smoke),
             "1x4-2heads": ((1, 4), smoke.replace(n_heads=2, n_kv_heads=2))}
    for name, (shape, cfg) in cases.items():
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        redraw_params_(params, 3)
        gen = torch.Generator().manual_seed(1)
        frames = torch.randn(2, 24, cfg.d_model, generator=gen)
        tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
        nxt = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
        with torch.inference_mode():
            want, cache = model.prefill(params, {"frames": frames, "tokens": tokens}, None)
            cache_before = {part: {kv: t.clone() for kv, t in c.items()}
                            for part, c in cache.items()}
            want_dec, _ = model.decode_step(params, nxt, cache, 8)  # writes the cache
            dparams = sh.distribute_tree(params, sh.param_shardings(
                param_axes(cfg), mesh, sh.PARAM_RULES, param_shapes(cfg)))
            with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
                batch = {"frames": sh.distribute_input(frames, "batch", "seq", "embed"),
                         "tokens": sh.distribute_input(tokens, "batch", "seq")}
                got, dcache = model.prefill(dparams, batch, None)
                caches = {f"{part}_{kv}": float((dcache[part][kv].full_tensor()
                                                 - cache_before[part][kv]).abs().max())
                          for part in ("self", "cross_kv") for kv in ("k", "v")}
                placed = all(sh.is_dtensor(t) for part in dcache.values() for t in part.values())
                dec, _ = model.decode_step(dparams, sh.distribute_input(nxt, "batch", "seq"),
                                           dcache, 8)
                got, dec = got.full_tensor(), dec.full_tensor()
        out[name] = {"heads": cfg.n_heads, "placed": placed, "caches": caches,
                     "logits": float((got - want).abs().max()),
                     "scale": float(want.abs().max()),
                     "decode": float((dec - want_dec).abs().max())}
    return out


def _entry_points_on(mesh) -> dict:
    """The kernels' entry points on DTensors (each runs its plain route per
    shard here) against the same calls on whole tensors: max |difference|."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import sharding as sh

    gen = torch.Generator().manual_seed(5)
    r = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    xh, dt, Bm, Cm = r(2, 16, 8, 4), torch.rand(2, 16, 8, generator=gen), r(2, 16, 6), r(2, 16, 6)
    A = -torch.rand(8, generator=gen)
    x, w = r(1, 8, 8, 16), r(8, 16, 12)
    out = {}
    with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
        d = lambda t, *axes: sh.distribute_input(t, *axes)  # noqa: E731
        got = ops.mamba_scan(d(xh, "batch", "seq", "ssm_heads", None), d(dt, "batch", "seq", None),
                             d(A, None), d(Bm, "batch", "seq", None), d(Cm, "batch", "seq", None), 8)
        out["mamba_scan"] = float((got.full_tensor() - ops.mamba_scan(xh, dt, A, Bm, Cm, 8)).abs().max())
        got = ops.gmm(d(x[0], "experts", None, None), d(w, None, None, None))
        out["gmm"] = float((got.full_tensor() - ops.gmm(x[0], w)).abs().max())
    return out


def _checkpoint_worker(rank, tmp):
    """Save on (2, 2) (async), restore onto (1, 2) and onto no mesh."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.checkpoint import _flatten

    big = make_mesh((2, 2), ("data", "model"), "cpu")
    small = make_mesh((1, 2), ("data", "model"), "cpu")
    fabric = _fabric("internlm2-1.8b", tmp, big, "ckpt")
    fabric.train_steps(1)
    saved = [x.full_tensor().numpy().copy() if hasattr(x, "full_tensor") else x.numpy().copy()
             for x in _flatten(fabric.state)]
    step = int(fabric.state.step)
    fabric.save_checkpoint(synchronous=False)
    result = fabric.reshard(small)
    out = {"reshard": result, "step": step}
    if result["member"]:
        leaves = _flatten(fabric.state)
        out["small_bit_equal"] = all(
            np.array_equal(x.full_tensor().numpy() if hasattr(x, "full_tensor") else x.numpy(), s)
            for x, s in zip(leaves, saved))
        out["small_placements"] = [str(x.placements) for x in leaves if hasattr(x, "placements")][:3]
        out["shards_are_local"] = all(x.to_local().numel() * 2 >= x.numel()
                                      for x in leaves if hasattr(x, "to_local"))
        # a plain target (no mesh): the same state on one rank
        plain = _fabric("internlm2-1.8b", tmp, None, f"plain{rank}")
        state, meta = ckpt.restore(fabric.ckpt_dir, plain.state)
        out["plain_bit_equal"] = all(np.array_equal(x.numpy(), s)
                                     for x, s in zip(_flatten(state), saved))
        out["plain_is_plain"] = not any(hasattr(x, "placements") for x in _flatten(state))
        out["meta_step"] = meta["step"]
        out["n_params"] = len(list(L.flatten_specs(state.params)))
    return out


# --- tests --------------------------------------------------------------------

_TRAIN: dict = {}


def _trained(arch, tmp_path, shape=(2, 2), n_experts=None):
    key = (arch, shape, n_experts)
    if key not in _TRAIN:
        _TRAIN[key] = run_ranks(tmp_path, _train_worker, arch=arch, shape=shape,
                                n_experts=n_experts)
    return _TRAIN[key]


@pytest.mark.parametrize(
    "arch,shape,n_experts",
    [(arch, (2, 2), None) for arch in ARCHS]
    + [("internlm2-1.8b", (1, 4), None), ("mixtral-8x7b", (1, 4), 2), ("xlstm-1.3b", (1, 4), None)],
    ids=[f"{arch}-2x2" for arch in ARCHS]
    + ["internlm2-1.8b-1x4", "mixtral-8x7b-2experts-1x4", "xlstm-1.3b-1x4"])
def test_sharded_training_matches_single_process(arch, shape, n_experts, tmp_path):
    """(1, 4) puts SMOKE internlm2's 2 kv heads on a model axis of 4: they
    stay whole on every rank, and their gradient is a partial sum.  Mixtral
    with 2 experts on 4 model ranks (the geometry of 8 experts on 16) splits
    the expert FFN's hidden dim over "model" (ROADMAP F8): each rank's
    output, and the gradients of its input, dispatch and combine, are
    partial sums over those ranks, and ``apply_moe(use_gmm=True)`` on the
    mesh matches whole tensors.  SMOKE xlstm's 2 heads on 4 model ranks
    split each head's work over 2 of them (ROADMAP F9): the mLSTM's value
    dim and the sLSTM's columns, which gather h among the 2 ranks every
    step, their sums and gradients over those 2 ranks alone."""
    results = _trained(arch, tmp_path, shape, n_experts)
    lead = results[0]
    want_splits = {("mixtral-8x7b", (2, 2)): {"moe": [0]}, ("mixtral-8x7b", (1, 4)): {"moe": []},
                   ("xlstm-1.3b", (2, 2)): {"xlstm": None, "slstm": None},
                   ("xlstm-1.3b", (1, 4)): {"xlstm": (1, 2), "slstm": (1, 2)}}
    assert lead["splits"] == want_splits.get((arch, shape), {}), lead["splits"]
    if n_experts is not None:
        assert lead["specs"]["h"] == ("data", None, None, "model"), lead["specs"]
        gmm = lead["gmm"]
        assert gmm["out"] <= 1e-5 * max(1.0, gmm["scale"]) and gmm["aux"] <= 1e-5, gmm
    if arch == "xlstm-1.3b" and shape == (1, 4):
        assert lead["specs"]["lstm_heads"] == (), lead["specs"]
    np.testing.assert_allclose(lead["losses"], lead["want_losses"], **LOSS_TOL)
    np.testing.assert_allclose(lead["grad_norms"], lead["want_grad_norms"], rtol=1e-4)
    assert lead["param_excess"] <= 0.0, lead["param_excess"]
    for r in results[1:]:  # every rank reports the same metrics
        assert r["losses"] == lead["losses"] and r["grad_norms"] == lead["grad_norms"]
    assert all(r["m_placements_match"] for r in results)


_DECODE: list = []


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_sharded_decode_matches_unsharded(case, tmp_path):
    """Prefill then 2 decode steps on the mesh: the logits and every cache
    leaf at the file's tolerances (1e-5 of each's scale).  Mixtral's 2
    tokens a step, and its 32-token prompt, are one routing group whose
    expert work the data ranks split (ROADMAP F11); xLSTM's decode runs its
    value projection on a data rank's rows (F12) and, with 2 heads on 4
    model ranks, its prefill and its decode steps split each head's work
    over 2 of them (F9, F14): the mLSTM's value dim, its C kept sliced by
    head and value columns in the cache (each leaf's ``full_tensor()`` the
    reference's shape and values), and the sLSTM's columns, its final
    state gathered to the cache's placement.  All cases run in one spawn
    of the ranks."""
    if not _DECODE:
        _DECODE.append(run_ranks(tmp_path, _decode_worker))
    results = _DECODE[0]
    arch, shape = DECODE_CASES[case]
    want_splits = {"mixtral-8x7b-2x2": {"moe": [0]},
                   "xlstm-1.3b-2x2": {"xlstm": None, "slstm": None},
                   "xlstm-1.3b-1x4": {"xlstm": (1, 2), "slstm": (1, 2)}}[case]
    for r in results:
        c = r[case]
        assert c["splits"] == want_splits, c["splits"]
        assert len(c["logits"]) == 3 and len(c["cache"]) > 0
        for diff, scale in c["logits"]:
            assert diff <= 1e-5 * max(1.0, scale), (case, c["logits"])
        for path, (diff, scale) in c["cache"].items():
            assert diff <= 1e-5 * max(1.0, scale), (case, path, diff, scale)


def test_split_slstm_matches_the_unsplit_op(tmp_path):
    """1e-5 of each's scale: the sLSTM split over each head's ranks, which
    gathers h among them inside the loop op every step and reduce-scatters
    its gradient every step back, against the op on whole tensors, on
    every rank: h, the final state, and the gradients of wx, R and the
    initial state."""
    results = run_ranks(tmp_path, _slstm_split_worker)
    for r in results:
        assert r["split"] == (1, 2), r["split"]
        assert len(r["diffs"]) == 5 + 12
        for i, (diff, scale) in enumerate(r["diffs"]):
            assert diff <= 1e-5 * max(1.0, scale), (i, diff, scale)


def test_grad_shardings_match_param_placements(tmp_path):
    results = _trained("internlm2-1.8b", tmp_path)
    assert all(r["grad_placements_match"] for r in results)
    # the redistribution does something: some raw gradients arrive elsewhere
    assert results[0]["raw_differ"] > 0


def test_flash_prefill_gqa_replicated_kv_matches_unsharded(tmp_path):
    results = run_ranks(tmp_path, _prefill_worker)
    for r in results:
        assert r["heads"] == (4, 2)
        assert r["kv_spec"] == ("data",)  # 2 kv heads on a model axis of 4: whole on every rank
        assert r["logits"] <= 1e-5 * max(1.0, r["scale"]), r
        assert r["cache"] <= 1e-5, r
        assert r["decode"] <= 1e-5 * max(1.0, r["scale"]), r
        assert max(r["entry"].values()) <= 1e-5, r["entry"]


def test_whisper_flash_prefill_matches_unsharded(tmp_path):
    """Whisper's caches are placed on the mesh (a ``copy_`` of a DTensor
    into a plain cache raised, ROADMAP F7); at the file's tolerances, with
    its 4 heads split over 2 and 4 model ranks and 2 heads on 4 gathered."""
    results = run_ranks(tmp_path, _whisper_prefill_worker)
    for r in results:
        assert set(r) == {"2x2", "1x4", "1x4-2heads"}
        for name, c in r.items():
            assert c["heads"] == (2 if name.endswith("2heads") else 4)
            assert c["placed"], name
            assert c["logits"] <= 1e-5 * max(1.0, c["scale"]), (name, c)
            assert max(c["caches"].values()) <= 1e-5, (name, c)
            assert c["decode"] <= 1e-5 * max(1.0, c["scale"]), (name, c)


def test_checkpoint_restores_onto_a_smaller_mesh_and_no_mesh(tmp_path):
    results = run_ranks(tmp_path, _checkpoint_worker)
    for rank, r in enumerate(results):
        assert r["reshard"]["old_mesh"] == (2, 2) and r["reshard"]["new_mesh"] == (1, 2)
        assert r["reshard"]["member"] == (rank < 2)
    for r in results[:2]:
        assert r["reshard"]["restored_step"] == r["step"] == r["meta_step"] == 1
        assert r["small_bit_equal"] and r["plain_bit_equal"] and r["plain_is_plain"]
        assert r["shards_are_local"]


def test_elastic_flow_shrinks_and_succeeds(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(["src", os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.elastic", "--device", "cpu",
         "--workdir", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"elastic launcher still running after {TIMEOUT} s\n{out[-6000:]}")
    assert proc.returncode == 0, out[-6000:]
    ranks = [json.loads(line) for line in out.splitlines() if line.startswith('{"rank"')]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["status"] == "SUCCEEDED"
        assert r["failure"] == "simulated device loss at step 6"
        assert r["reshard"]["old_mesh"] == [2, 2] and r["reshard"]["new_mesh"] == [1, 2]
    assert [r["reshard"]["member"] for r in ranks] == [True, True, False, False]
    assert all(r["final_step"] >= 10 and r["reshard"]["restored_step"] == 5 for r in ranks[:2])
