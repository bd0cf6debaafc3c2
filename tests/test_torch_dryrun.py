"""The port's dry-run (``repro_torch.launch.{specs,dryrun,hlo,roofline}``)
on the CPU, at SMOKE configs and the reference's tiny shapes
(``tests/launch/test_specs_dryrun.py``).

Every fake world (``dryrun.fake_world``: rank 0 of a fake process group)
is formed and destroyed inside one test, by ``run_cell`` or by the
``fake_world`` fixture, so a worker that runs this file next to others is
left with no process group.  Each test states its tolerance; all but
zamba2's in (j) are exact (counts, bytes, shapes, FLOPs are integers):

* (a) ``input_specs``: leaf order (paths), global shapes and dtypes equal
  the reference's for train, prefill and decode of every SMOKE arch,
  caches included, the port's specs on a fake (16, 16) world;
* (b) ``act_rules_for``'s long_500k rule, as the reference's test;
* (c) the collective parser on a hand-built graph: exact bytes and wire
  bytes, as ``test_hlo_collective_parser``;
* (d) per-device FLOPs on a fake (1, 4) world: a column-sharded matmul
  counts 2 M K N / 4 exactly, and a ``Partial`` -> ``Replicate`` one
  all-reduce of 2x its local bytes;
* (e) no double counting: a SMOKE internlm2 train step traced on a fake
  (1, 1) world counts exactly the FLOPs ``FlopCounterMode`` counts around
  the same step run eagerly on real CPU tensors without DTensor;
* (f) ``analyze`` and ``model_flops`` with the H100 constants;
* (g) ``params_total`` / ``params_active`` equal the reference's for every
  arch;
* (h) every SMOKE cell's ``run_cell`` on a fake (16, 16) world, in a file
  of its own (``tests/test_torch_dryrun_cells.py``); here a saved record
  feeds the roofline, and a failed or refused trace is an error record;
* (i) a prefill cell with ``attention_impl="flash"`` traces through the
  kernels' custom ops and counts their FLOP formula;
* (j) the placements against the reference's, on a (2, 4) mesh, for the
  train, prefill and decode cells of every SMOKE arch: in a file of its own
  (``tests/test_torch_placements.py``), which compiles the reference's
  steps one JAX process an arch.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jax_configs  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.launch.mesh import make_mesh as jax_make_mesh  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, hlo, roofline  # noqa: E402
from repro_torch.launch import specs as specs_mod  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BANDWIDTH,
    INTER_NODE_BANDWIDTH,
    PEAK_FLOPS_BF16,
    make_mesh,
)
from repro_torch.models.model import (  # noqa: E402
    Model,
    active_params_analytic,
    count_params_analytic,
)
from repro_torch.train.loop import init_state, make_train_step  # noqa: E402

TINY_TRAIN = ShapeConfig("train_4k", "train", seq_len=32, global_batch=4)
TINY_PREFILL = ShapeConfig("prefill_32k", "prefill", seq_len=32, global_batch=2)
TINY_DECODE = ShapeConfig("decode_32k", "decode", seq_len=32, global_batch=2)
TINY = {"train": TINY_TRAIN, "prefill": TINY_PREFILL, "decode": TINY_DECODE}


def _jax_shape(shape: ShapeConfig):
    return jax_configs.base.ShapeConfig(shape.name, shape.kind, shape.seq_len,
                                        shape.global_batch)


@pytest.fixture
def smoke(monkeypatch):
    """``run_cell`` builds each arch's SMOKE config."""
    get = configs.get
    monkeypatch.setattr(configs, "get", lambda arch, smoke=True: get(arch, smoke=True))


@pytest.fixture
def fake_world():
    """``make(world_size)`` forms a fake world; it is destroyed at teardown."""
    stack = []

    def make(world_size: int):
        ctx = dryrun.fake_world(world_size)
        ctx.__enter__()
        stack.append(ctx)

    yield make
    while stack:
        stack.pop().__exit__(None, None, None)
    assert not torch.distributed.is_initialized()


# --- (a) specs against the reference ------------------------------------------------


def _port_leaves(tree, path=()):
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield path, tuple(tree.shape), str(tree.dtype).removeprefix("torch.")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], path + (str(k),))
    else:
        names = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (names[i] if names else str(i),))


def _jax_leaves(tree):
    out = []
    for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                     for k in keys)
        out.append((path, tuple(leaf.shape), str(np.dtype(leaf.dtype))))
    return out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(fake_world, kind):
    """Exact: the same leaves in the same order, shapes and dtypes."""
    fake_world(256)
    mesh = make_mesh((16, 16), ("data", "model"), "cpu")
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    for arch in configs.REFERENCE_ARCH_IDS:
        port = specs_mod.input_specs(configs.get(arch, smoke=True), TINY[kind], mesh)
        ref = jax_specs.input_specs(jax_configs.get(arch, smoke=True),
                                    _jax_shape(TINY[kind]), jmesh)
        assert list(port) == list(ref), arch
        for name in ref:
            assert list(_port_leaves(port[name])) == _jax_leaves(ref[name]), (arch, name)


def test_specs_are_fake_dtensors_on_the_mesh(fake_world):
    """A spec holds its global shape and its local shard; nothing is real."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor, Shard

    fake_world(256)
    mesh = make_mesh((16, 16), ("data", "model"), "cpu")
    cfg = configs.get("internlm2-1.8b")
    state = specs_mod.state_specs(cfg, mesh)
    table = state.params["embed"]["table"]  # ("vocab", "embed")
    assert isinstance(table, DTensor) and isinstance(table._local_tensor, FakeTensor)
    assert tuple(table.shape) == (cfg.vocab_size, cfg.d_model)
    assert tuple(table.placements) == (Shard(1), Shard(0))
    assert tuple(table._local_tensor.shape) == (cfg.vocab_size // 16, cfg.d_model // 16)
    assert tuple(state.opt.m["embed"]["table"].placements) == (Shard(1), Shard(0))


# --- (b) the long_500k rule ----------------------------------------------------------


def test_long_500k_rules_shard_kv_seq():
    """As ``test_long_500k_rules_shard_kv_seq``; exact."""
    cfg = configs.get("zamba2-7b", smoke=True)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
    rules = specs_mod.act_rules_for(cfg, ShapeConfig("long_500k", "decode", 1024, 1), mesh)
    assert rules.rules["kv_seq"] == ("pod", "data")
    assert rules.rules["seq"] is None
    train_rules = specs_mod.act_rules_for(cfg, ShapeConfig("train_4k", "train", 4096, 256),
                                          mesh)
    assert train_rules.rules["kv_seq"] is None


# --- (c) the collective parser ---------------------------------------------------------


def test_collective_parser():
    """A hand-built graph of one rank's ops; exact bytes and wire bytes."""
    f = torch.ops._c10d_functional
    g = torch.fx.Graph()

    def node(target, args, shape):
        n = g.call_function(target, args)
        n.meta["val"] = torch.empty(shape, dtype=torch.float32, device="meta")
        return n

    p = g.placeholder("p")
    p.meta["val"] = torch.empty(128, 64, device="meta")
    ag = node(f.all_gather_into_tensor.default, (p, 2, "0"), (256, 64))
    node(f.wait_tensor.default, (ag,), (256, 64))
    ar = node(f.all_reduce.default, (p, "sum", "0"), (128, 64))
    ar_w = node(f.wait_tensor.default, (ar,), (128, 64))
    rs = node(f.reduce_scatter_tensor.default, (ar_w, "sum", 2, "0"), (64, 64))
    g.output((node(f.wait_tensor.default, (rs,), (64, 64)),))

    stats = hlo.analyze_collectives(g)
    assert stats["all-gather"] == {"count": 1, "operand_bytes": 128 * 64 * 4,
                                   "result_bytes": 256 * 64 * 4}
    assert stats["all-reduce"]["operand_bytes"] == 128 * 64 * 4
    assert stats["reduce-scatter"]["operand_bytes"] == 128 * 64 * 4
    assert stats["reduce-scatter"]["result_bytes"] == 64 * 64 * 4
    assert stats["_total"]["count"] == 3  # wait_tensor is not a collective
    # wire: all-reduce 2x operand + all-gather result + reduce-scatter operand
    expected = 2 * 128 * 64 * 4 + 256 * 64 * 4 + 128 * 64 * 4
    assert stats["_total"]["wire_bytes_per_device"] == expected
    assert [o["wire_bytes"] for o in stats["_top_ops"]] == [256 * 64 * 4, 2 * 128 * 64 * 4,
                                                           128 * 64 * 4]


def test_memory_analysis_liveness():
    """Exact: the peak of the intermediates live at once, arguments and
    outputs apart, and what is live there."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(1024)  # 4 KiB argument

        def fn(x):
            a = x * 2          # 4 KiB, read by b and c
            b = a + 1          # 4 KiB, read by c
            c = a * b          # a, b die here
            d = c.sum()        # c dies here; d is the output
            return d

        g = dryrun.lower(fn, x)
    mem = hlo.memory_analysis(g)
    assert mem["argument_size_in_bytes"] == 4096
    assert mem["output_size_in_bytes"] == 4
    assert mem["alias_size_in_bytes"] == 0
    assert mem["temp_size_in_bytes"] == 3 * 4096  # a, b and c live at c
    # the breakdown at that peak: each by the op that made it
    assert sorted((e["op"], e["count"], e["bytes"]) for e in mem["temp_at_peak"]) == [
        ("aten.add.Tensor", 1, 4096), ("aten.mul.Tensor", 2, 8192)]


# --- (d) per-device FLOPs and collectives ------------------------------------------------


def test_per_device_flops_and_partial_all_reduce(fake_world):
    """Exact: FLOPs on the local shards (not the global op) and one
    all-reduce of 2x the partial result's local bytes."""
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor

    fake_world(4)
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    M, K, N = 256, 512, 1024
    with specs_mod.fake_mode():
        def place(shape, placements):
            return distribute_tensor(torch.empty(shape), mesh, placements, src_data_rank=None)

        x = place((M, K), [Replicate(), Replicate()])
        w = place((K, N), [Replicate(), Shard(1)])       # column-sharded
        x2 = place((M, K), [Replicate(), Shard(1)])
        w2 = place((K, N), [Replicate(), Shard(0)])      # row-sharded: a partial sum

        def fn(x, w, x2, w2):
            y = x @ w
            z = x2 @ w2
            assert isinstance(z.placements[1], Partial)
            return y, z.redistribute(mesh, [Replicate(), Replicate()])

        graph = dryrun.lower(fn, x, w, x2, w2)
    mms = [n for n in graph.nodes if n.target is torch.ops.aten.mm.default]
    assert [tuple(n.meta["val"].shape) for n in mms] == [(M, N // 4), (M, N)]
    assert hlo.node_flops(mms[0]) == 2 * M * K * N // 4
    assert hlo.node_flops(mms[1]) == 2 * M * (K // 4) * N
    assert hlo.cost_analysis_dict(graph)["flops"] == 2 * M * K * N // 4 + 2 * M * (K // 4) * N
    stats = hlo.analyze_collectives(graph)
    assert stats["_total"]["count"] == 1
    assert stats["all-reduce"] == {"count": 1, "operand_bytes": M * N * 4,
                                   "result_bytes": M * N * 4}
    assert stats["_total"]["wire_bytes_per_device"] == 2 * M * N * 4


# --- (e) no double counting -------------------------------------------------------------


def test_train_step_flops_equal_flop_counter_on_real_tensors(smoke):
    """Exact: the (1, 1) trace's FLOPs equal ``FlopCounterMode``'s around
    the same step on real tensors (forward, remat recompute and backward
    each counted once)."""
    from torch.utils.flop_counter import FlopCounterMode

    arch = "internlm2-1.8b"
    rec = dryrun.run_cell(arch, "train_4k", "single", device="cpu",
                          shape=TINY_TRAIN, mesh_shape=(1, 1), save=False)
    assert rec["status"] == "ok", rec.get("traceback")

    cfg = configs.get(arch, smoke=True)
    model = Model(cfg)
    state = init_state(model, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (TINY_TRAIN.global_batch, TINY_TRAIN.seq_len))
    step = make_train_step(model, TrainConfig())
    with FlopCounterMode(display=False) as counter:
        step(state, {"tokens": tokens, "labels": tokens})
    assert counter.get_total_flops() > 0
    assert rec["cost"]["flops"] == counter.get_total_flops()


# --- (j) the placements against the reference's: tests/test_torch_placements.py ------------


# --- (f) the roofline ------------------------------------------------------------------


def test_roofline_analyze_math():
    """Each term is one second at the H100 constants (approx 1e-12 rel)."""
    record = {
        "arch": "x", "shape": "train_4k", "mesh": "single", "chips": 256,
        "kind": "train", "seq_len": 4096, "global_batch": 256,
        "params_total": 2_000_000_000, "params_active": 1_000_000_000,
        "status": "ok",
        "cost": {"flops": PEAK_FLOPS_BF16, "bytes accessed": HBM_BANDWIDTH},
        "collectives": {"_total": {"wire_bytes_per_device": INTER_NODE_BANDWIDTH}},
        "memory": {},
    }
    row = roofline.analyze(record)
    assert row["compute_s"] == pytest.approx(1.0, rel=1e-12)
    assert row["memory_s"] == pytest.approx(1.0, rel=1e-12)
    assert row["collective_s"] == pytest.approx(1.0, rel=1e-12)
    assert row["model_flops"] == 6.0 * 1e9 * 256 * 4096  # active params
    assert 0 < row["roofline_fraction"] <= 1.0
    assert (PEAK_FLOPS_BF16, HBM_BANDWIDTH, INTER_NODE_BANDWIDTH) == (989e12, 3.35e12, 50e9)


def test_model_flops_kinds():
    base = {"params_active": 1e9, "global_batch": 8, "seq_len": 100}
    assert roofline.model_flops({**base, "kind": "train"}) == 6e9 * 800
    assert roofline.model_flops({**base, "kind": "prefill"}) == 2e9 * 800
    assert roofline.model_flops({**base, "kind": "decode"}) == 2e9 * 8


# --- (g) parameter counts -----------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.REFERENCE_ARCH_IDS)
def test_param_counts_match_reference(arch):
    """Exact, full configs (counted, never built)."""
    cfg, jcfg = configs.get(arch), jax_configs.get(arch)
    assert count_params_analytic(cfg) == jax_model.count_params_analytic(jcfg)
    assert active_params_analytic(cfg) == jax_model.active_params_analytic(jcfg)


# --- (h) cells on the production mesh: tests/test_torch_dryrun_cells.py ---------------------


def test_records_feed_the_roofline(smoke, tmp_path, monkeypatch):
    """A saved record reads back through ``load_records`` into a table row."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    rec = dryrun.run_cell("internlm2-1.8b", "decode_32k", "single", device="cpu",
                          shape=TINY_DECODE, mesh_shape=(2, 2))
    assert rec["status"] == "ok", rec.get("traceback")
    with open(tmp_path / "internlm2-1.8b__decode_32k__single.json") as fh:
        assert json.load(fh)["cost"] == rec["cost"]
    rows = [roofline.analyze(r) for r in roofline.load_records(mesh="single")]
    assert len(rows) == 1 and rows[0]["compute_s"] > 0
    assert "| internlm2-1.8b | decode_32k | single |" in roofline.markdown_table(rows)


def test_failed_trace_is_an_error_record(smoke, monkeypatch):
    """A cell whose trace stops (here at an op budget) is recorded as an
    error with its reason, and leaves no process group behind."""
    monkeypatch.setattr(dryrun, "MAX_OPS", 50)
    rec = dryrun.run_cell("internlm2-1.8b", "train_4k", "single", device="cpu",
                          shape=TINY_TRAIN, mesh_shape=(1, 1), save=False)
    assert rec["status"] == "error"
    assert rec["error"].startswith("TraceTooLarge")
    assert not torch.distributed.is_initialized()


def test_unchecked_torch_release_is_refused(smoke, monkeypatch):
    """A torch release the tracer's frame names were not checked on ends the
    cell with an error naming the releases that were."""
    monkeypatch.setattr(torch, "__version__", "2.99.0")
    rec = dryrun.run_cell("internlm2-1.8b", "train_4k", "single", device="cpu",
                          shape=TINY_TRAIN, mesh_shape=(1, 1), save=False)
    assert rec["status"] == "error"
    assert "2.99.0" in rec["error"] and str(dryrun.CHECKED_TORCH) in rec["error"]


# --- (i) the kernels as custom ops ------------------------------------------------------------


def _pairs_by_mask(S, T, causal, window):
    qp, kp = torch.arange(S)[:, None], torch.arange(T)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    return int(mask.sum())


@pytest.mark.parametrize("S,T,causal,window", [
    (32, 32, True, None), (37, 37, True, 16), (64, 192, True, None),
    (100, 200, False, None), (300, 300, True, 100), (50, 80, False, 20)])
def test_attended_pairs_is_the_mask_count(S, T, causal, window):
    """Exact, against ``chip_smoke.py``'s mask."""
    assert ops.attended_pairs(S, T, causal, window) == _pairs_by_mask(S, T, causal, window)


def test_kernel_entry_points_are_custom_ops():
    """Fake implementations give shape and dtype; ``FlopCounterMode``
    counts each formula; a CPU tensor still takes the plain version, and an
    input that requires grad still raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 4, 16, generator=g)
    k = torch.randn(2, 8, 2, 16, generator=g)
    v = torch.randn(2, 8, 2, 16, generator=g)
    xh = torch.randn(1, 16, 2, 8, generator=g)
    dt = torch.rand(1, 16, 2, generator=g)
    A = -torch.rand(2, generator=g)
    Bm, Cm = torch.randn(1, 16, 4, generator=g), torch.randn(1, 16, 4, generator=g)
    x, w = torch.randn(4, 8, 16, generator=g), torch.randn(2, 16, 32, generator=g)
    calls = {
        "flash_attention": (lambda: ops.flash_attention(q, k, v, causal=True),
                            lambda: ref.attention_ref(q, k, v, causal=True),
                            4 * 2 * 4 * 16 * _pairs_by_mask(8, 8, True, None)),
        "mamba_scan": (lambda: ops.mamba_scan(xh, dt, A, Bm, Cm, chunk=8),
                       lambda: ref.mamba_scan_ref(xh, dt, A, Bm, Cm)[0],
                       1 * 2 * (2 * 8 * 8 * 4 + 2 * (2 * 8 * 8 * 8 + 4 * 8 * 8 * 4))),
        "gmm": (lambda: ops.gmm(x, w), lambda: ref.gmm_ref(x, w), 2 * 4 * 8 * 16 * 32),
    }
    for name, (call, plain, flops) in calls.items():
        assert hasattr(torch.ops.repro_torch, name)
        torch.testing.assert_close(call(), plain(), rtol=0, atol=0)
        with FlopCounterMode(display=False) as counter:
            out = call()
        assert counter.get_total_flops() == flops, name
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake = call()
        assert (fake.shape, fake.dtype) == (out.shape, out.dtype), name
    with pytest.raises(NotImplementedError):
        ops.gmm(x, w.clone().requires_grad_())


def test_flash_prefill_traces_through_the_kernel(smoke, fake_world):
    """Exact: one flash node a layer, each counted by the kernel's formula
    on its local shard, and their sum inside the cell's FLOPs."""
    arch, shape = "internlm2-1.8b", TINY_PREFILL
    cfg = configs.get(arch, smoke=True)
    rec = dryrun.run_cell(arch, shape.name, "single", device="cpu", shape=shape,
                          mesh_shape=(2, 2), save=False, cfg_override={"attention_impl": "flash"})
    assert rec["status"] == "ok", rec.get("traceback")
    # the graph itself, to read the kernel's nodes
    fake_world(4)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    fcfg = cfg.replace(attention_impl="flash")
    with specs_mod.fake_mode():
        sp = specs_mod.input_specs(fcfg, shape, mesh)
        graph = dryrun.lower(dryrun.make_step_fn(fcfg, shape, mesh), sp["params"], sp["batch"])
    flash = [n for n in graph.nodes if n.target is torch.ops.repro_torch.flash_attention.default]
    assert len(flash) == cfg.n_layers
    B_local, H_local = shape.global_batch // 2, cfg.n_heads // 2
    per_layer = 4 * B_local * H_local * cfg.resolved_head_dim * _pairs_by_mask(
        shape.seq_len, shape.seq_len, True, None)
    assert [hlo.node_flops(n) for n in flash] == [per_layer] * cfg.n_layers
    assert rec["cost"]["flops"] == hlo.cost_analysis_dict(graph)["flops"]
    assert rec["cost"]["flops"] > per_layer * cfg.n_layers


#: xLSTM at d 256 with 4 heads, one mLSTM and one sLSTM block: on a fake
#: (2, 16) world the geometry of xlstm-1.3b on (16, 16), each head's columns
#: over 4 model ranks
XLSTM_SMALL = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, vocab_size=512)


def _xlstm_small():
    from repro_torch.configs.base import XLSTMConfig

    return dict(XLSTM_SMALL, xlstm=XLSTMConfig(slstm_every=2, conv_width=4, chunk_size=16,
                                               proj_factor=2.0))


def test_xlstm_value_split_moves_no_more_bytes_than_heads_whole(monkeypatch):
    """xLSTM's splits over a head's ranks (ROADMAP F9, F14: 4 heads on 16
    model ranks, the geometry of xlstm-1.3b on (16, 16)), each against the
    same step with every head whole on every model rank: a train step at d
    256 on a fake (2, 16) world (the mLSTM's value split and the sLSTM's
    recurrence split) and a decode step at decode_32k's sizes a rank (d
    2048, 128 rows over 16 data ranks, (16, 16), 2 layers; the mLSTM's
    state sliced in the cache, the sLSTM's single step split).  Each runs
    fewer FLOPs a rank, moves no more wire bytes and holds no more temp
    memory.  Their sums run over a head's 4 ranks alone; the first split
    summed zero-padded tensors over all 16 and moved 1.25x the heads-whole
    bytes in the train step (1.60x at full size, PERF.md).  A decode step
    at d 256 and 4 rows a rank is where the sLSTM's split moves more bytes
    than its heads whole (``xlstm.slstm_cell``)."""
    from repro_torch.models import xlstm

    cells = {"train": (_xlstm_small(), ShapeConfig("train_4k", "train", 128, 4), (2, 16)),
             "decode": (dict(_xlstm_small(), d_model=2048),
                        ShapeConfig("decode_32k", "decode", 64, 128), (16, 16))}

    def cell(kind):
        cfg, shape, mesh_shape = cells[kind]
        rec = dryrun.run_cell("xlstm-1.3b", shape.name, "single", cfg_override=cfg, shape=shape,
                              mesh_shape=mesh_shape, save=False, device="cpu")
        assert rec["status"] == "ok", rec.get("traceback")
        return (rec["cost"]["flops"], rec["collectives"]["_total"]["wire_bytes_per_device"],
                rec["memory"]["temp_size_in_bytes"])

    split = {kind: cell(kind) for kind in cells}
    monkeypatch.setattr(xlstm, "_head_split", lambda *a: None)
    for kind in cells:
        whole = cell(kind)
        assert split[kind][0] < whole[0] / 1.5, (kind, split[kind], whole)
        assert split[kind][1] <= whole[1], (kind, split[kind], whole)
        assert split[kind][2] <= whole[2], (kind, split[kind], whole)


def test_slstm_split_counts_its_collectives_a_step(fake_world):
    """Exact: on a fake (2, 16) world, a train step's one sLSTM layer (d 256,
    4 heads, each head's 64 columns over 4 ranks, S = 128) is one
    ``slstm_scan`` node, which runs S all-gathers of h [B, 1, 16] into
    [B, 1, 64] f32 among a head's ranks, and one ``slstm_scan_backward``
    node, which runs S reduce-scatters back, B = 2 rows a data rank: their
    registered formula, counted by ``analyze_collectives`` beside the
    collectives DTensor issues."""
    fake_world(32)
    cfg = configs.get("xlstm-1.3b").replace(unroll_layers=True, **_xlstm_small())
    shape = ShapeConfig("train_4k", "train", 128, 4)
    mesh = make_mesh((2, 16), ("data", "model"), "cpu")
    with specs_mod.fake_mode():
        sp = specs_mod.input_specs(cfg, shape, mesh)
        graph = dryrun.lower(dryrun.make_step_fn(cfg, shape, mesh), sp["state"], sp["batch"])
    ops_ = {name: [n for n in graph.nodes if n.op == "call_function"
                   and getattr(n.target, "overloadpacket", None) is getattr(torch.ops.repro_torch,
                                                                           name)]
            for name in ("slstm_scan", "slstm_scan_backward")}
    assert [len(v) for v in ops_.values()] == [1, 1]
    S, B, w, dh = 128, 2, 16, 64
    assert hlo._collectives_of(ops_["slstm_scan"][0]) == [("all-gather", S, B * w * 4,
                                                           B * dh * 4)]
    assert hlo._collectives_of(ops_["slstm_scan_backward"][0]) == [
        ("reduce-scatter", S, B * dh * 4, B * w * 4)]
    plain = {"all-gather": 0, "reduce-scatter": 0}
    for n in graph.nodes:
        name = hlo.collective_name(n.target) if n.op == "call_function" else None
        if name in plain:
            plain[name] += 1
    stats = hlo.analyze_collectives(graph)
    assert stats["all-gather"]["count"] == plain["all-gather"] + S
    assert stats["reduce-scatter"]["count"] == plain["reduce-scatter"] + S
