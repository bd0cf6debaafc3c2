"""The MoE training cell's check at SMOKE sizes on the CPU: sound runs are
correct; the faults the model can have each fail a limit (the shared experts
dropped, softmax in place of sigmoid scores, the latent's RMSNorm skipped,
the bias update skipped), and so does the control; mixtral's serve cell
still routes through ``top_k_dispatch``, once a layer a step.  Beside them,
the new readers and FLOP counts by hand.  The SMOKE limits and the readings
they were set from are in ``smoke_moe.py``."""

import dataclasses
import time
import types

import pytest
import torch

from portbench.harness import bench, flops_mla_moe
from portbench.tests.smoke import smoke_root
from portbench.tests.smoke_moe import CELL, moe_smoke_root

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13, 2**31 + 14)


def _run(tmp_path, seed=SEEDS[0], control=False, cell=CELL):
    root = moe_smoke_root(tmp_path)
    return bench.run(bench.load_cell(cell, root), seed, 0.5, False, "cpu", time.perf_counter(),
                     control=control)


def _failed(out) -> list:
    return [k for k, c in out["checks"].items()
            if c["value"] is None or not c["value"] <= c["limit"]]


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_runs_are_correct(tmp_path, seed):
    out = _run(tmp_path, seed)
    assert out["correct"], out["checks"]
    assert out["checks"]["bias_off"]["value"] == 0


def test_the_shared_experts_dropped(tmp_path, monkeypatch):
    from repro_torch.models import layers as L
    from repro_torch.models import moe

    monkeypatch.setattr(moe, "L", types.SimpleNamespace(
        init_mlp=L.init_mlp, apply_mlp=lambda params, x, kind: torch.zeros_like(x)))
    out = _run(tmp_path)
    assert not out["correct"] and "grad_gap" in _failed(out), out["checks"]


def test_softmax_in_place_of_sigmoid(tmp_path, monkeypatch):
    from repro_torch.models import moe

    real = moe.select_experts

    def softmax(logits, cfg, bias=None):
        return real(logits, cfg.replace(moe=dataclasses.replace(cfg.moe, score_func="softmax")))

    monkeypatch.setattr(moe, "select_experts", softmax)
    out = _run(tmp_path)
    assert not out["correct"], out["checks"]


def test_the_latent_norm_skipped(tmp_path, monkeypatch):
    from repro_torch.models import layers as L

    real = L.apply_norm

    def skip_latent(params, x, norm_type, eps):
        return x if x.shape[-1] == 32 else real(params, x, norm_type, eps)  # kv_lora_rank

    monkeypatch.setattr(L, "apply_norm", skip_latent)
    out = _run(tmp_path)
    assert not out["correct"], out["checks"]


def test_the_bias_update_skipped(tmp_path, monkeypatch):
    from repro_torch.models import moe

    monkeypatch.setattr(moe.Balance, "update_", lambda self, gamma: setattr(self, "total", None))
    out = _run(tmp_path)
    assert not out["correct"] and "bias_off" in _failed(out), out["checks"]


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_the_control_fails(tmp_path, seed):
    out = _run(tmp_path, seed, control=True)
    c = bench.load_cell(CELL, moe_smoke_root(tmp_path / "again"))
    ok, checks = bench.judge(out["readings"]["control"], c.spec["limits"])
    assert not ok, checks
    assert not bench.judge(out["readings"]["half_batch"], c.spec["limits"])[0]


def test_mixtral_still_routes_through_top_k_dispatch(tmp_path, monkeypatch):
    """One ``top_k_dispatch`` call a layer a step of the served batch, as the
    serve check reads it (``route_calls_off`` 0), and none of the dropless
    layer's ``select_experts``."""
    from repro_torch.models import moe

    calls = {"select": 0}
    real = moe.select_experts

    def spy(*args, **kw):
        calls["select"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(moe, "select_experts", spy)
    out = _run(tmp_path, cell="mixtral-serve-decode")
    assert out["correct"], out["checks"]
    assert out["checks"]["route_calls_off"]["value"] == 0 and calls["select"] == 0


@pytest.mark.parametrize("cell, metric", [(CELL, "flow_overhead_share.train"),
                                          ("internlm2-serve-long", "step_mfu.serve")])
def test_accepted_readers_read_the_new_cells(tmp_path, cell, metric):
    """The readers of the host clock that the new cells share with the old
    ones find their numbers in a SMOKE run's record."""
    c = bench.load_cell(cell, moe_smoke_root(tmp_path) if cell == CELL else smoke_root(tmp_path))
    assert metric in c.per_layer
    out = bench.driver(c).run(c, SEEDS[0], 0.5, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert 0 < bench.reader(metric)(out["record"]) < 100


def test_readers_with_nothing_to_read_return_nothing():
    for name in ("step_mfu.train_moe", "mla_share.train", "moe_share.train",
                 "expert_load_max.train"):
        assert bench.reader(name)({"trace": None}) is None, name
    # a join without the latent attention's or the MoE's spans reads nothing
    program = {"device_s": 1.0, "by_span": {"block.attention": {"count": 2, "device_total_s": 0.5}}}
    for name in ("mla_share.train", "moe_share.train", "expert_load_max.train"):
        assert bench.reader(name)({"trace": {"program": program}}) is None, name


def test_readers_of_a_join():
    by_span = {
        "attention.mla": {"count": 4, "device_total_s": 0.1, "attrs": {}},
        "block.attention": {"count": 4, "device_total_s": 0.6, "attrs": {}},
        "moe.route": {"count": 2, "device_total_s": 0.05,
                      "attrs": {"held_rows": 160, "held_max_rows": 50, "held_experts": 8}},
        "moe.experts": {"count": 2, "device_total_s": 0.1, "attrs": {}},
        "moe.shared": {"count": 2, "device_total_s": 0.05, "attrs": {}},
    }
    run = {"trace": {"program": {"device_s": 2.0, "by_span": by_span}}}
    assert bench.reader("mla_share.train")(run) == pytest.approx(30.0)
    assert bench.reader("moe_share.train")(run) == pytest.approx(10.0)
    # two calls of 4 experts each: 160 rows, 20 an expert; the busiest 25 a call
    assert bench.reader("expert_load_max.train")(run) == pytest.approx(50 / (160 / 4))
    run = {"steady_s": 2.0, "mla_moe_flops_steady": 989e12}
    assert bench.reader("step_mfu.train_moe")(run) == pytest.approx(50.0)


def test_flops_by_hand():
    cfg = dict(n_layers=3, d_model=64, n_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, first_dense_layers=1, dense_d_ff=128,
               vocab_size=256, moe={"n_experts": 4, "router_experts": 8, "top_k": 3,
                                    "d_ff": 32, "n_shared_experts": 2})
    # q 64 x 96, latent 64 x 40, up 32 x 128, out 64 x 64
    attn = 2 * (64 * 96 + 64 * 40 + 32 * 128 + 64 * 64)
    assert flops_mla_moe.attention_flops_per_token(cfg) == attn
    # router 64 x 8; shared 2 experts and 3 * 4 / 8 routed, each 3 x 64 x 32
    assert flops_mla_moe.moe_flops_per_token(cfg) == 2 * (64 * 8 + 3 * 64 * 32 * (2 + 1.5))
    B, S = 2, 8
    per_tok = 3 * attn + 2 * 3 * 64 * 128 + 2 * flops_mla_moe.moe_flops_per_token(cfg) \
        + 2 * 64 * 256
    pairs = 3 * 2 * 4 * (24 + 16) * (S * (S + 1) // 2)
    assert flops_mla_moe.train_step_flops(cfg, B, S) == pytest.approx(
        3 * B * (S * per_tok + pairs))
