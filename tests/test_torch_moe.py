"""The port's MoE slice against the JAX package: the grouped matmul and its
plain version, the expert FFN, routing and dispatch, the MoE layer, and
mixtral-8x7b / qwen3-moe-235b-a22b at SMOKE size, on the CPU.

Kernel-level tolerances are the reference's own (``tests/kernels/
test_kernels.py:20-21,175,190``): f32 2e-5, bf16 2e-2, the expert FFN and
the MoE layer 2e-4.  Model logits are held at 1e-4 in f32, as in
``tests/test_torch_serve.py``; dispatch tensors must be identical and token
arrays too.  Weights are redrawn from a seed by
:func:`repro_torch.testing.redraw_params_` and cross to JAX through the
bridge; inputs are seeded numpy.  The CUDA kernel itself runs only on the
card, where ``chip_smoke.py`` holds it against ``gmm_ref``.

Run as a script, the file prints the bf16 distances behind the bf16 checks
here and behind ``chip_smoke.py``'s limit for ``apply_moe(use_gmm=True)``:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_moe.py
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.moe_gmm import gmm as jax_gmm
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tfm
from repro.models.model import Model as JaxModel
from repro.models.model import active_params_analytic as jax_active_params
from repro.serve.engine import BatchAccumulator as JaxAccumulator
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.kernels import moe_gmm as gmm_kernel
from repro_torch.kernels import ops, ref
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model, active_params_analytic, count_params_analytic
from repro_torch.serve.engine import BatchAccumulator, ServeEngine
from repro_torch.testing import redraw_params_

ARCHS = ["mixtral-8x7b", "qwen3-moe-235b-a22b"]
# the reference's kernel tolerances (tests/kernels/test_kernels.py:20-21)
KERNEL_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# expert FFN and MoE layer, f32 (tests/kernels/test_kernels.py:175,190)
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)
# logits at the end of the SMOKE stack, f32 (tests/test_torch_serve.py)
TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 MoE layer, port vs JAX (relative L2), where one routing decision apart
# would show as a far larger distance
BF16_LAYER_TOL = 2e-2
# bf16 whole SMOKE forward: port vs jitted JAX within this many times JAX's
# own jitted-vs-op-by-op spread, and the median per-position bf16-vs-f32
# drifts within 10 % (see test_bf16_forward_matches_jax)
SPREAD_FACTOR = 2
DRIFT_RATIO = 0.1
B, S = 2, 12
jax_forward = jax.jit(jax_tfm.forward_lm, static_argnums=1)
jax_prefill = jax.jit(jax_tfm.prefill_lm, static_argnums=(1, 3))
jax_decode = jax.jit(jax_tfm.decode_lm, static_argnums=1)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), _np(j), **tol)


def _rel(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# grouped matmul and the expert FFN
# ---------------------------------------------------------------------------

# E, C, D, F, Ew, the Pallas kernel's blocks: the three shapes of
# tests/kernels/test_kernels.py:139-146, and groups cycling over fewer slabs
GMM_CASES = [
    (4, 64, 32, 48, 4, (32, 16, 16)),
    (2, 128, 64, 64, 2, (64, 64, 64)),
    (8, 16, 128, 32, 8, (16, 32, 64)),
    (6, 16, 32, 48, 3, (16, 16, 16)),
]


def _gmm_inputs(case):
    E, C, D, F, Ew, _ = case
    rng = np.random.default_rng(E * 1000 + C)
    return (rng.standard_normal((E, C, D)).astype(np.float32),
            rng.standard_normal((Ew, D, F)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_gmm(case, dtype) -> np.ndarray:
    bc, bf, bd = case[-1]
    x, w = (jnp.asarray(a).astype(dtype) for a in _gmm_inputs(case))
    out = jax_gmm(x, w, block_c=bc, block_f=bf, block_d=bd, interpret=True)
    assert out.dtype == x.dtype
    return _np(out)


@pytest.mark.parametrize("port_fn", ["gmm_ref", "ops.gmm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GMM_CASES, ids=lambda c: "-".join(map(str, c[:5])))
def test_gmm_matches_jax_pallas(case, dtype, port_fn):
    x, w = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in _gmm_inputs(case))
    fn = ref.gmm_ref if port_fn == "gmm_ref" else ops.gmm
    out = fn(x, w)
    assert out.dtype == x.dtype and out.shape == (case[0], case[1], case[3])
    np.testing.assert_allclose(_np(out), _jax_gmm(case, dtype), **KERNEL_TOL[dtype])


def test_gmm_ref_takes_slabs_that_do_not_divide_the_groups():
    """E 5 over Ew 3: slab e % Ew, where E/Ew is no whole number."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 8, 16)).astype(np.float32)
    w = rng.standard_normal((3, 16, 24)).astype(np.float32)
    out = ref.gmm_ref(torch.from_numpy(x), torch.from_numpy(w))
    expected = np.stack([x[e] @ w[e % 3] for e in range(5)])
    np.testing.assert_allclose(out.numpy(), expected, **KERNEL_TOL["float32"])


def _experts(cfg, scale=0.1, seed=0):
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(shape) * scale).astype(np.float32)
            for name, shape in (("gate", (E, D, F)), ("up", (E, D, F)), ("down", (E, F, D)))}


@pytest.mark.parametrize("port_fn", ["moe._swiglu", "expert_mlp_ref"])
@pytest.mark.parametrize("grouped", [True, False], ids=["4d", "3d"])
def test_moe_expert_mlp_matches_jax(grouped, port_fn):
    """The SwiGLU expert FFN of three grouped matmuls (the MoE layer's, with
    ``use_gmm``); [G,E,C,D] (G 2) and the reference's squeezed [E,C,D]."""
    cfg = configs.get("mixtral-8x7b", smoke=True)
    shape = ((2,) if grouped else ()) + (cfg.moe.n_experts, 16, cfg.d_model)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    experts = _experts(cfg)
    jcfg = jax_configs.get("mixtral-8x7b", smoke=True)
    jx, jexperts = jnp.asarray(x), {k: jnp.asarray(v) for k, v in experts.items()}
    texperts = {k: torch.from_numpy(v) for k, v in experts.items()}
    if port_fn == "moe._swiglu":
        tx = torch.from_numpy(x) if grouped else torch.from_numpy(x)[None]
        out = moe._swiglu(True, tx, *(texperts[n] for n in ("gate", "up", "down")))
        out = out if grouped else out[0]
        expected = jax_ops.moe_expert_mlp(jx, jexperts, jcfg)
    else:
        out = ref.expert_mlp_ref(torch.from_numpy(x), texperts)
        expected = jax_ref.expert_mlp_ref(jx, jexperts)
    assert out.shape == x.shape
    _close(out, expected, LAYER_TOL)


def test_gmm_kernel_refuses_cpu_tensors():
    """The kernel's wrapper launches or raises; it never computes on the CPU."""
    x, w = (torch.from_numpy(a) for a in _gmm_inputs(GMM_CASES[0]))
    before = gmm_kernel.gmm.launches
    with pytest.raises(ValueError, match="CUDA"):
        gmm_kernel.gmm(x, w)
    assert gmm_kernel.gmm.launches == before


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------


def _both(arch, smoke=True, **kw):
    return (jax_configs.get(arch, smoke=smoke).replace(**kw),
            configs.get(arch, smoke=smoke).replace(**kw))


@pytest.mark.parametrize("n_tokens", [1, 7, 8, 64, 100, 2048, 4008, 4096, 6000, 12345])
def test_capacity_and_groups_match_jax(n_tokens):
    """Both MoE configs, full and SMOKE, and three group sizes; 4008 is a
    serving prefill batch of 8 x 501 tokens (one group, C 1256 on mixtral)."""
    for arch in ARCHS:
        for smoke in (False, True):
            jcfg, tcfg = _both(arch, smoke)
            for group_size in (16, 512, moe.DEFAULT_GROUP_SIZE):
                groups = moe.group_tokens(n_tokens, group_size)
                assert groups == jax_moe.group_tokens(n_tokens, group_size)
                assert n_tokens % groups == 0
                tg = n_tokens // groups
                assert moe.capacity_for(tg, tcfg) == jax_moe.capacity_for(tg, jcfg)
    assert moe.capacity_for(4008, configs.get("mixtral-8x7b")) == 1256


# arch, G, T, capacity (None: capacity_for(T)); 8 is below demand, so tokens
# overflow and the k-major slot order decides which are dropped
DISPATCH_CASES = [("mixtral-8x7b", 2, 64, None), ("mixtral-8x7b", 2, 64, 8),
                  ("qwen3-moe-235b-a22b", 3, 40, None), ("qwen3-moe-235b-a22b", 1, 96, 8)]


@pytest.mark.parametrize("case", DISPATCH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_top_k_dispatch_matches_jax(case):
    arch, G, T, capacity = case
    jcfg, tcfg = _both(arch)
    capacity = capacity or moe.capacity_for(T, tcfg)
    E, k = tcfg.moe.n_experts, tcfg.moe.top_k
    logits = np.random.default_rng(G * T).standard_normal((G, T, E)).astype(np.float32)
    jd, jc, jaux = jax_moe.top_k_dispatch(jnp.asarray(logits), jcfg, capacity)
    td, tc, taux = moe.top_k_dispatch(torch.from_numpy(logits), tcfg, capacity)
    assert td.dtype == torch.bool and tc.dtype == torch.float32
    assert tuple(td.shape) == (G, T, E, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)
    # every slot holds at most one token
    assert (td.sum(dim=1) <= 1).all()
    choices = np.argsort(-logits, axis=-1)[..., :k]
    _check_k_major(td.numpy(), choices, capacity)
    demand = np.stack([(choices == e).sum(axis=(1, 2)) for e in range(E)], axis=-1)
    placed = td.sum(dim=(2, 3))  # choices placed per token
    assert bool((placed < k).any()) == bool((demand > capacity).any())
    if case[3] is not None:  # the case below demand: overflow is dropped
        assert (demand > capacity).any()


def _check_k_major(dispatch, choices, capacity):
    """Choice j of every token is slotted before choice j + 1 of any: expert
    e's slots go to the tokens choosing it first, in token order, then to
    those choosing it second, until C is full; the rest are dropped."""
    G, T, E, _ = dispatch.shape
    for g in range(G):
        for e in range(E):
            order = [t for j in range(choices.shape[-1]) for t in range(T)
                     if choices[g, t, j] == e]
            for slot, t in enumerate(order):
                expected = np.zeros(capacity, bool)
                if slot < capacity:
                    expected[slot] = True
                np.testing.assert_array_equal(dispatch[g, t, e], expected)


def _moe_params(cfg, seed=0):
    """One MoE layer's params (numpy): router std 1/sqrt(D), so its logits
    are O(1) and well apart; experts std 1/sqrt(d_in)."""
    rng = np.random.default_rng(seed)
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
    experts = {name: (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
               for name, shape in (("gate", (E, D, F)), ("up", (E, D, F)), ("down", (E, F, D)))}
    return {"router": {"w": (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)},
            "experts": experts}


@pytest.mark.parametrize("group_size", [moe.DEFAULT_GROUP_SIZE, 16])
@pytest.mark.parametrize("use_gmm", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, use_gmm, group_size):
    """The MoE layer, port against JAX on the same route; group size 16 splits
    the 64 tokens into 4 groups of capacity 8 (mixtral SMOKE) and drops."""
    jcfg, tcfg = _both(arch)
    params = _moe_params(tcfg)
    x = np.random.default_rng(3).standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = jax.tree_util.tree_map(torch.from_numpy, params)
    jout, jaux = jax_moe.apply_moe(jparams, jcfg, jnp.asarray(x), group_size=group_size,
                                   use_gmm=use_gmm)
    tout, taux = moe.apply_moe(tparams, tcfg, torch.from_numpy(x), group_size=group_size,
                               use_gmm=use_gmm)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    _close(tout, jout, LAYER_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_bf16_matches_jax(arch):
    """One MoE layer in bf16, both routes of the port against jitted JAX's
    einsum route.  The router product stays f32 on both sides, so the aux loss,
    a function of the router logits alone, must agree to f32 rounding: a
    router run in bf16 moves it by some 2e-5 while the outputs, 5e-3 apart
    from JAX's by bf16 rounding alone, move by less than 10 %."""
    jcfg, tcfg = _both(arch, compute_dtype="bfloat16")
    params = _moe_params(tcfg)
    x = np.random.default_rng(3).standard_normal((4, 32, tcfg.d_model)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = jax.tree_util.tree_map(torch.from_numpy, params)
    jout, jaux = jax.jit(lambda p, x: jax_moe.apply_moe(p, jcfg, x))(
        jparams, jnp.asarray(x, jnp.bfloat16))
    for use_gmm in (False, True):
        tout, taux = moe.apply_moe(tparams, tcfg, torch.from_numpy(x).bfloat16(),
                                   use_gmm=use_gmm)
        assert tout.dtype == torch.bfloat16 and taux.dtype == torch.float32
        assert _rel(tout, jout) <= BF16_LAYER_TOL, use_gmm
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the model at SMOKE size
# ---------------------------------------------------------------------------


def _cfgs(arch, **kw):
    return _both(arch, compute_dtype="float32", attention_impl="flash", **kw)


@functools.lru_cache(maxsize=None)
def _tree(arch) -> dict:
    _, tcfg = _cfgs(arch)
    params = Model(tcfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    redraw_params_(params, seed=13)
    return bridge.params_to_jax(params, tcfg)


def _params(arch, tcfg):
    tree = _tree(arch)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_jax(tree, tcfg, device="cpu"))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_active_params_match_jax():
    for arch in ARCHS:
        for smoke in (False, True):
            jcfg, tcfg = _both(arch, smoke)
            assert active_params_analytic(tcfg) == jax_active_params(jcfg)
    dense = configs.get("internlm2-1.8b")
    assert active_params_analytic(dense) == count_params_analytic(dense)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    """Logits, the layer-averaged aux loss, and Model.loss with its aux term."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(arch, tcfg)
    tokens = _tokens(tcfg, (B, S + 1))
    jlogits, jaux = jax_forward(jparams, jcfg, jnp.asarray(tokens[:, :-1]))
    tlogits, taux = tfm.forward_lm(tparams, tcfg, torch.from_numpy(tokens[:, :-1]).long())
    assert tlogits.shape == (B, S, tcfg.vocab_size) and float(taux) > 0
    _close(tlogits, jlogits)
    _close(taux, jaux)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    jloss = JaxModel(jcfg).loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(tcfg)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tloss = model.loss(tparams, tbatch)
    _close(tloss, jloss)
    no_aux = Model(tcfg.replace(moe=dataclasses.replace(tcfg.moe, aux_loss_weight=0.0))
                   ).loss(tparams, tbatch)
    assert float(tloss - no_aux) == pytest.approx(tcfg.moe.aux_loss_weight * float(taux),
                                                  rel=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_8_decode_steps_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(arch, tcfg)
    tokens = _tokens(tcfg, (B, S + 8))
    max_len = tokens.shape[1]
    jlogits, jcache = jax_prefill(jparams, jcfg, jnp.asarray(tokens[:, :S]), max_len)
    tlogits, tcache = tfm.prefill_lm(tparams, tcfg, torch.from_numpy(tokens[:, :S]).long(),
                                     max_len)
    assert tlogits.shape == (B, 1, tcfg.vocab_size)
    _close(tlogits, jlogits)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    for pos in range(S, S + 8):
        new = tokens[:, pos:pos + 1]
        jlogits, jcache = jax_decode(jparams, jcfg, jnp.asarray(new), jcache,
                                     jnp.asarray(pos, jnp.int32))
        tlogits, tcache = tfm.decode_lm(tparams, tcfg, torch.from_numpy(new).long(), tcache, pos)
        _close(tlogits, jlogits)
    _close(tcache["v"], jcache["v"])


def test_sliding_window_runs_in_prefill_and_decode():
    """mixtral SMOKE's window is 32: a 44-token prompt and 8 decode steps past
    it differ from the same model without the window, and match JAX."""
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    assert tcfg.sliding_window == 32
    jparams, tparams = _params("mixtral-8x7b", tcfg)
    tokens = _tokens(tcfg, (B, 44 + 8), seed=5)
    max_len = tokens.shape[1]
    out = {}
    for window in (32, None):
        jc, tc = jcfg.replace(sliding_window=window), tcfg.replace(sliding_window=window)
        jl, jcache = jax_prefill(jparams, jc, jnp.asarray(tokens[:, :44]), max_len)
        tl, tcache = tfm.prefill_lm(tparams, tc, torch.from_numpy(tokens[:, :44]).long(),
                                    max_len)
        _close(tl, jl)
        steps = []
        for pos in range(44, 52):
            new = tokens[:, pos:pos + 1]
            jl, jcache = jax_decode(jparams, jc, jnp.asarray(new), jcache,
                                    jnp.asarray(pos, jnp.int32))
            tl, tcache = tfm.decode_lm(tparams, tc, torch.from_numpy(new).long(), tcache, pos)
            _close(tl, jl)
            steps.append(_np(tl))
        out[window] = np.stack(steps)
    assert np.abs(out[32] - out[None]).max() > 1e-2


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_decode_walk_a_leading_dense_stack(impl):
    """An MoE stack behind a leading dense layer (``first_dense_layers``, as
    GLM-4.5 and DeepSeek-V3 lay theirs out) with GQA attention: prefill and 4
    decode steps walk the blocks ``forward_lm`` walks, dense first, one cache
    slot a block, and give its logits on the same tokens.  The capacity
    drops nothing, so that the routing groups' sizes do not matter."""
    base = configs.get("mixtral-8x7b", smoke=True)
    cfg = base.replace(
        n_layers=3, first_dense_layers=1, dense_d_ff=96, compute_dtype="float32",
        attention_impl=impl, moe=dataclasses.replace(base.moe, capacity_factor=2.0))
    assert cfg.n_kv_heads < cfg.n_heads
    params = Model(cfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    redraw_params_(params, seed=13)
    assert params["dense_blocks"]["mlp"]["up"]["w"].shape[0] == 1
    assert params["blocks"]["moe"]["router"]["w"].shape[0] == 2
    tokens = torch.from_numpy(_tokens(cfg, (B, S + 4))).long()
    with torch.no_grad():
        want, _ = tfm.forward_lm(params, cfg, tokens)
        got, cache = tfm.prefill_lm(params, cfg, tokens[:, :S], S + 4)
        assert cache["k"].shape[0] == cfg.n_layers
        torch.testing.assert_close(got[:, 0], want[:, S - 1], **TOL)
        for pos in range(S, S + 4):
            got, cache = tfm.decode_lm(params, cfg, tokens[:, pos:pos + 1], cache, pos)
            torch.testing.assert_close(got[:, 0], want[:, pos], **TOL)


def _serve(engine_cls, accum_cls, model, params, prompts, eos, **kw):
    engine = engine_cls(model, params, max_len=64, eos_token=eos, **kw)
    accum = accum_cls(engine, max_batch=3)
    for p in prompts:
        accum.submit(p)
    return accum.flush(max_new_tokens=8), engine.stats


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_tokens_identical_to_jax(arch):
    """Greedy serving of ragged, left-padded prompts longer than mixtral
    SMOKE's window, with and without EOS; pad tokens are routed and take
    capacity on both sides."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(arch, tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab_size, n) for n in (40, 51, 33, 56, 45)]
    jax_side = (JaxEngine, JaxAccumulator, JaxModel(jcfg), jparams, prompts)
    port_side = (ServeEngine, BatchAccumulator, Model(tcfg), tparams, prompts)

    ref_out, _ = _serve(*port_side, None, device="cpu")
    eos = int(ref_out[0]["tokens"][2])  # ends request 0 after 3 tokens
    for eos_token in (None, eos):
        jout, jstats = _serve(*jax_side, eos_token)
        tout, tstats = _serve(*port_side, eos_token, device="cpu")
        assert tstats == jstats
        assert len(tout) == len(jout) == len(prompts)
        for t, j in zip(tout, jout):
            assert t["prompt_len"] == j["prompt_len"]
            np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert (tout[0]["tokens"][3:] == eos).all() and len(tout[0]["tokens"]) == 8


def test_model_path_never_calls_gmm(monkeypatch):
    """Forward, prefill and decode run the einsum expert FFN, as the
    reference's model path does; only apply_moe(use_gmm=True) reaches gmm,
    three times a call."""
    calls = []
    real = ops.gmm

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "gmm", spy)
    before = gmm_kernel.gmm.launches
    _, tcfg = _cfgs("mixtral-8x7b")
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0), device="cpu")
    tokens = torch.ones((1, 5), dtype=torch.long)
    model.forward(params, {"tokens": tokens})
    _, cache = model.prefill(params, {"tokens": tokens}, 8)
    model.decode_step(params, tokens[:, :1], cache, 5)
    assert calls == []
    layer = tfm.layer_params(params["blocks"], 0)["moe"]
    moe.apply_moe(layer, tcfg, torch.randn(1, 5, tcfg.d_model), use_gmm=True)
    E, C = tcfg.moe.n_experts, moe.capacity_for(5, tcfg)
    assert calls == [(E, C, tcfg.d_model)] * 2 + [(E, C, tcfg.moe.d_ff)]
    assert gmm_kernel.gmm.launches == before


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------


def _median_rel(a, b) -> float:
    """Median over positions of each position's relative L2 distance."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.median(np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)))


def distances(arch) -> dict:
    """Relative L2 distances of SMOKE forward logits (B 8, S 32) between the
    two packages and the two dtypes; JAX jitted, and in bf16 also op by op;
    over all logits, and as the median over positions."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(arch, tcfg)
    tokens = _tokens(tcfg, (8, 32))
    jtok = jnp.asarray(tokens)
    bf16 = jcfg.replace(compute_dtype="bfloat16")
    out = {("jax", "float32"): jax_forward(jparams, jcfg, jtok)[0],
           ("jax", "bfloat16"): jax_forward(jparams, bf16, jtok)[0],
           "jax_op_by_op": jax_tfm.forward_lm(jparams, bf16.replace(unroll_layers=True), jtok)[0]}
    for dtype in ("float32", "bfloat16"):
        with torch.inference_mode():
            out["port", dtype] = tfm.forward_lm(tparams, tcfg.replace(compute_dtype=dtype),
                                                torch.from_numpy(tokens).long())[0]
    assert out["port", "bfloat16"].dtype == torch.bfloat16
    return {
        "jax_drift": _rel(out["jax", "bfloat16"], out["jax", "float32"]),
        "port_drift": _rel(out["port", "bfloat16"], out["port", "float32"]),
        "jax_op_by_op_drift": _rel(out["jax_op_by_op"], out["jax", "float32"]),
        "jax_median_drift": _median_rel(out["jax", "bfloat16"], out["jax", "float32"]),
        "port_median_drift": _median_rel(out["port", "bfloat16"], out["port", "float32"]),
        "port_bf16_vs_jax_op_by_op": _rel(out["port", "bfloat16"], out["jax_op_by_op"]),
        "jax_jit_vs_op_by_op": _rel(out["jax", "bfloat16"], out["jax_op_by_op"]),
        "port_bf16_vs_jax_bf16": _rel(out["port", "bfloat16"], out["jax", "bfloat16"]),
        "port_f32_vs_jax_f32": _rel(out["port", "float32"], out["jax", "float32"]),
    }


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_jax(arch):
    """Port vs JAX in bf16 over the whole SMOKE forward.

    Two correct bf16 implementations differ by about as much as bf16 moves
    the logits: JAX's own jitted and op-by-op runs sit 7.1e-2 (mixtral) and
    2.2e-2 (qwen3) apart, so the port is held against jitted JAX within twice
    that spread, as tests/test_torch_zamba.py does.  The whole-tensor
    bf16-vs-f32 drift is no witness here: a rounding difference flips a
    near-tied routing decision at a few positions, whose logits then move by
    tens of percent (JAX jitted 3.7e-2, JAX op by op 7.3e-2 on mixtral).  The
    median over positions is unmoved by those few (1.28e-2 to 1.32e-2 for
    all three runs), so the port's median drift is held within 10 % of
    jitted JAX's."""
    d = distances(arch)
    assert d["port_f32_vs_jax_f32"] <= 1e-5, d
    assert d["port_bf16_vs_jax_bf16"] <= SPREAD_FACTOR * d["jax_jit_vs_op_by_op"], d
    assert abs(d["port_median_drift"] / d["jax_median_drift"] - 1) <= DRIFT_RATIO, d


def gmm_route_distance(d_model: int, d_ff: int, seed: int = 0, tokens: int = 512) -> dict:
    """The port alone on the CPU: apply_moe(use_gmm=True) (gmm_ref, which sums
    in f32 and rounds each product to bf16 once, as the kernel does) against
    use_gmm=False (bf16 einsums), in bf16 and f32, at mixtral's 8 experts and
    top-2 with the width cut to ``d_model`` and ``d_ff``; 8 x ``tokens``
    tokens of N(0, 1) input.  The witness for chip_smoke.py's bf16 limit
    (GMM_ROUTE_WITNESS there)."""
    cfg = configs.get("mixtral-8x7b").replace(d_model=d_model)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, d_ff=d_ff))
    params = jax.tree_util.tree_map(torch.from_numpy, _moe_params(cfg, seed))
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (8, tokens, d_model)).astype(np.float32))
    out = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for use_gmm in (False, True):
                out[dtype, use_gmm] = moe.apply_moe(params, cfg, x.to(dtype), use_gmm=use_gmm)[0]
    return {"bf16": _rel(out[torch.bfloat16, True], out[torch.bfloat16, False]),
            "f32": _rel(out[torch.float32, True], out[torch.float32, False]),
            "bf16_vs_f32": _rel(out[torch.bfloat16, False], out[torch.float32, False])}


def main() -> None:
    for arch in ARCHS:
        print(f"{arch} SMOKE forward (relative L2 of the logits):", distances(arch))
    # widths doubling towards mixtral's d 4096 / d_ff 14336, then each of its
    # two sum lengths (D for gate and up, d_ff for down) at full size
    for d_model, d_ff, tokens in ((512, 1792, 512), (1024, 3584, 512), (2048, 7168, 512),
                                  (2048, 14336, 256), (4096, 3584, 256)):
        for seed in (0, 1):
            print(f"apply_moe gmm vs einsum route, d {d_model}, d_ff {d_ff}, 8 x {tokens} "
                  f"tokens, seed {seed}:", gmm_route_distance(d_model, d_ff, seed, tokens))


if __name__ == "__main__":
    main()
