"""Moonlight-16B-A3B (DeepSeek-V3's block) in the port against a plain float32
reference (``tests/torch_reference/deepseek_v3.py``, which imports nothing of
the port), at SMOKE size on the CPU: latent attention, a leading dense layer,
sigmoid routing with a correction bias over a router wider than the experts
held, shared experts, dropless dispatch, the sequence-wise balance loss and
the bias update.

Tolerances, all in float32 (``compute_dtype="float32"``): the logits 1e-4,
as every port test holds logits at the end of a stack (the two sides sum in
other orders: the reference runs every expert on every token and weighs it
by a gate that is zero where the expert was not chosen); the loss 1e-5
relative; each leaf's gradient by the worst leaf's relative L2, 1e-4 (a few
ulps of f32 through three layers); each leaf's change after two AdamW steps
by the worst leaf's relative L2, 1e-2, the benchmark's ``change_gap``: Adam's
first step moves every element by lr times the sign of its gradient, so an
element whose gradient lies within rounding of zero moves the other way on
one side (a few in 1e4 here, 2.3e-3 read); the expert counts and the biases
exactly, since both sides pick the same experts.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, tracing  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.testing import redraw_params_  # noqa: E402
from repro_torch.train import loop  # noqa: E402

ARCH = "moonlight-16b-a3b"
B, S = 2, 16


def _reference():
    path = Path(__file__).parent / "torch_reference" / "deepseek_v3.py"
    spec = importlib.util.spec_from_file_location("deepseek_v3_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()


def _cfg(**kw):
    return configs.get(ARCH, smoke=True).replace(compute_dtype="float32", **kw)


def _params(cfg, seed=0):
    params = Model(cfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    redraw_params_(params, seed)
    return params


def _batch(cfg, seed=1, rows=B):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, cfg.vocab_size, (rows, S + 1), generator=g)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def test_smoke_config_has_the_published_structure():
    """A dense layer, then MoE layers whose router is wider than the experts
    held; the full config holds the published numbers."""
    cfg, full = configs.get(ARCH, smoke=True), configs.get(ARCH)
    assert cfg.first_dense_layers == 1 and cfg.n_layers > 2
    assert cfg.moe.n_router > cfg.moe.n_experts and cfg.moe.n_shared_experts == 2
    assert (full.n_layers, full.d_model, full.n_heads, full.vocab_size) == (27, 2048, 16, 163840)
    assert (full.kv_lora_rank, full.qk_nope_head_dim, full.qk_rope_head_dim,
            full.v_head_dim) == (512, 128, 64, 128)
    assert (full.moe.n_router, full.moe.top_k, full.moe.d_ff, full.dense_d_ff) == \
        (64, 6, 1408, 11264)
    assert full.moe.score_func == "sigmoid" and full.moe.routed_scale == 2.446
    assert ARCH in configs.ARCH_IDS and ARCH not in configs.REFERENCE_ARCH_IDS


def test_forward_loss_and_every_gradient_match_the_reference():
    cfg = _cfg()
    model, params, batch = Model(cfg), _params(cfg), _batch(cfg)
    d = dataclasses.asdict(cfg)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    bias = torch.zeros(n_moe, cfg.moe.n_router)

    balance = moe.Balance(bias.clone())
    logits, _ = model.forward(params, batch, balance)
    ref_logits, _, ref_counts = REF.forward(params, d, batch["tokens"], bias)
    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-4)
    assert torch.equal(torch.stack([balance.load[i] for i in range(n_moe)]),
                       ref_counts.long())

    loss, grads = L.value_and_grad(model.loss, params, batch, moe.Balance(bias.clone()))
    ref_params = L.map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
    ref_loss, _ = REF.loss(ref_params, d, batch["tokens"], batch["labels"], bias)
    assert float(loss) == pytest.approx(float(ref_loss.detach()), rel=1e-5)
    ref_loss.backward()
    worst = max(_rel(g, r.grad) for (_, g), (_, r) in zip(L.flatten_specs(grads),
                                                           L.flatten_specs(ref_params)))
    assert worst < 1e-4, worst


def test_the_balance_term_is_in_the_loss():
    """alpha times each MoE layer's sequence-wise balance loss, summed: the
    loss less the cross-entropy, against the reference's term."""
    cfg = _cfg()
    params, batch = _params(cfg), _batch(cfg)
    bias = torch.zeros(cfg.n_layers - cfg.first_dense_layers, cfg.moe.n_router)
    full = Model(cfg).loss(params, batch, moe.Balance(bias.clone()))
    ce = Model(cfg.replace(moe=dataclasses.replace(cfg.moe, balance_alpha=0.0))).loss(
        params, batch, moe.Balance(bias.clone()))
    _, balance, _ = REF.forward(params, dataclasses.asdict(cfg), batch["tokens"], bias)
    _, aux = Model(cfg).forward(params, batch, moe.Balance(bias.clone()))
    assert float(balance) > 0
    # forward's aux is the MoE layers' sum, as the reference's
    assert float(aux) == pytest.approx(float(balance), rel=1e-5)
    # the difference of two f32 losses near 5.9 is good to some 1e-6
    assert float(full - ce) == pytest.approx(cfg.moe.balance_alpha * float(balance), abs=2e-6)


def _adamw(p, g, m, v, step, tc):
    """The published AdamW step (decoupled decay inside the lr product), the
    gradient clipped to the global norm first; the lr of the port's
    schedule at ``step`` (warm-up)."""
    norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
    scale = min(tc.max_grad_norm / max(float(norm), 1e-9), 1.0)
    lr = tc.learning_rate * (step + 1) / tc.warmup_steps
    for k in p:
        gk = g[k] * scale
        m[k] = tc.beta1 * m[k] + (1 - tc.beta1) * gk
        v[k] = tc.beta2 * v[k] + (1 - tc.beta2) * gk * gk
        m_hat = m[k] / (1 - tc.beta1 ** (step + 1))
        v_hat = v[k] / (1 - tc.beta2 ** (step + 1))
        p[k] = p[k] - lr * (m_hat / (torch.sqrt(v_hat) + tc.eps) + tc.weight_decay * p[k])


@pytest.mark.parametrize("remat,microbatches", [("none", 1), ("full", 1), ("full", 2)])
def test_two_steps_with_the_bias_update_match_the_reference(remat, microbatches):
    """Two train steps (AdamW, then the bias update from the step's counts,
    the two microbatches' summed) against the reference's loss, the
    published AdamW and the bias rule; the bias gets no gradient and no
    AdamW, and a remat's recompute counts nothing twice."""
    cfg = _cfg(remat_policy=remat)
    tc = TrainConfig(warmup_steps=100, microbatches=microbatches)
    model = Model(cfg)
    params = _params(cfg)
    p0 = {"/".join(k): t.clone() for k, t in L.flatten_specs(params)}
    state = loop.TrainState(params, loop.opt.init_adamw(params), model.init_buffers("cpu"))
    assert not any("router_bias" in "/".join(k) for k, _ in L.flatten_specs(state.params))
    step = loop.make_train_step(model, tc)
    batches = [_batch(cfg, seed=s) for s in (1, 2)]
    for b in batches:
        state, _ = step(state, b)

    d = dataclasses.asdict(cfg)
    p = dict(p0)
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    bias = torch.zeros_like(state.buffers["router_bias"])
    for i, b in enumerate(batches):
        leaves = {k: t.clone().requires_grad_(True) for k, t in p.items()}
        tree = L.unflatten((tuple(k.split("/")), t) for k, t in leaves.items())
        loss, counts = REF.loss(tree, d, b["tokens"], b["labels"], bias)
        loss.backward()
        _adamw(p, {k: t.grad for k, t in leaves.items()}, m, v, i, tc)
        bias = REF.update_bias(bias, counts, cfg.moe.bias_update)

    assert torch.equal(state.buffers["router_bias"], bias)
    assert float(bias.abs().max()) == pytest.approx(2 * cfg.moe.bias_update)
    worst = max(_rel(t - p0["/".join(k)], p["/".join(k)] - p0["/".join(k)])
                for k, t in L.flatten_specs(state.params))
    assert worst < 1e-2, worst


def _layer_inputs(cfg, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, S, cfg.d_model, generator=g)


def test_disjoint_expert_shares_add_up_to_the_uncut_layer():
    """Every disjoint share of one MoE layer's experts, as a chip of an
    expert-parallel deployment holds it, with the shared experts (which every
    chip computes alike) counted once, adds up to the uncut reference layer."""
    cfg = _cfg()
    E, held = cfg.moe.n_router, 2
    whole = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=E))
    layer = tfm_moe_params(whole)
    x = _layer_inputs(cfg)
    bias = torch.linspace(-0.05, 0.05, E)
    ref, _, _ = REF.moe(layer, dataclasses.asdict(whole), x, bias)
    shared = L.apply_mlp(layer["shared"], x, "swiglu")
    total = -(E // held - 1) * shared
    for lo in range(0, E, held):
        part = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=held, first_expert=lo))
        share = dict(layer, experts={k: w[lo:lo + held] for k, w in layer["experts"].items()})
        bal = moe.Balance(bias[None].clone())
        out, _ = moe.apply_moe(share, part, x, balance=bal, layer=0)
        total = total + out
    torch.testing.assert_close(total, ref, rtol=1e-5, atol=1e-5)


def tfm_moe_params(cfg, seed=0):
    from repro_torch.models.layers import materialize

    params = materialize(torch.Generator().manual_seed(0), moe.init_moe(cfg), torch.float32, "cpu")
    redraw_params_(params, seed)
    return params


def test_dropless_dispatch_equals_capacity_dispatch_that_drops_nothing():
    """Mixtral's routing (softmax top-2) through the dropless path and through
    ``top_k_dispatch`` at a capacity that holds every token: the same output
    and aux loss.  This ties the new path to mixtral's."""
    cfg = configs.get("mixtral-8x7b", smoke=True).replace(compute_dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts))
    params = tfm_moe_params(cfg)
    x = _layer_inputs(cfg)
    out_c, aux_c = moe.apply_moe(params, cfg, x)
    dropless = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="dropless"))
    out_d, aux_d = moe.apply_moe(params, dropless, x)
    torch.testing.assert_close(out_d, out_c, rtol=1e-5, atol=1e-5)
    assert float(aux_d) == pytest.approx(float(aux_c), rel=1e-6)


def test_mixtral_keeps_capacity_dispatch():
    cfg = configs.get("mixtral-8x7b")
    assert cfg.moe.dispatch == "capacity" and cfg.moe.score_func == "softmax"
    assert cfg.moe.n_router == cfg.moe.n_experts and Model(cfg).init_buffers("cpu") == {}


def test_spans_and_counters_of_a_train_step():
    """With tracing on, one train step at SMOKE size records the new spans:
    ``attention.mla`` a layer, ``moe.route`` (held rows, the largest held
    expert's rows, the experts held), ``moe.shared`` and ``moe.experts`` an
    MoE layer (and their backward), ``moe.balance`` once with the largest
    |bias|.  With tracing off nothing is recorded."""
    cfg = _cfg()
    model = Model(cfg)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    params = _params(cfg)
    state = loop.TrainState(params, loop.opt.init_adamw(params), model.init_buffers("cpu"))
    step = loop.make_train_step(model, TrainConfig())
    tracing.drain()
    state, _ = step(state, _batch(cfg))
    assert tracing.drain() == []

    tracing.enable()
    try:
        balance = moe.Balance(state.buffers["router_bias"].clone())
        model.forward(params, _batch(cfg), balance)
        step(state, _batch(cfg))
    finally:
        tracing.disable()
    spans = tracing.drain()

    def named(name, backward=False):
        return [s for s in spans if s["name"] == name
                and bool(s["attrs"].get("backward")) == backward]

    assert len(named("attention.mla")) == 2 * cfg.n_layers
    route = named("moe.route")
    assert len(route) == 2 * n_moe
    held = cfg.moe.n_experts
    first = route[:n_moe]
    for i, s in enumerate(first):
        counts = balance.load[i][:held].tolist()
        assert s["attrs"] == {"held_rows": sum(counts), "held_max_rows": max(counts),
                              "held_experts": held}
    for name in ("moe.shared", "moe.experts"):
        assert len(named(name)) == 2 * n_moe
        assert len(named(name, backward=True)) == n_moe
    (bal,) = named("moe.balance")
    assert bal["attrs"]["bias_abs_max"] == pytest.approx(
        float(state.buffers["router_bias"].abs().max()))


def test_serving_entry_points_refuse_latent_attention():
    cfg = _cfg()
    model = Model(cfg)
    params = _params(cfg)
    with pytest.raises(NotImplementedError, match="no KV cache"):
        model.prefill(params, _batch(cfg), S + 2)
    with pytest.raises(NotImplementedError, match="no KV cache"):
        model.init_cache(B, S + 2, device="cpu")
