"""The port's xLSTM family (xlstm-1.3b) against the JAX package, at SMOKE sizes.

Weights are redrawn from a seed by :func:`repro_torch.testing.redraw_params_`
(the reference's init takes the fan-in from the stacking axis, and xLSTM
stacks its mLSTM blocks twice) and cross to the JAX package through the
bridge; the regression pins of ``tests/models/test_xlstm_regression.py`` use
the reference's own init, bridged, as the pins do.  Inputs are seeded numpy.
Tolerances are the reference's: the cells in f32 at rtol = atol = 2e-5,
logits at the end of the stack at 1e-4, one bf16 block at 2e-2 (relative L2).
The two loops are ops (``repro_torch::mlstm_chunkwise``, ``::slstm_scan``)
whose backward ops are written by hand from the residuals their forwards
save: each is held against autograd through its plain loop at 2e-5 (and
the sLSTM's and, through the regression pins, the mLSTM's against
``jax.grad`` at 1e-4); both ops' FLOP formulas equal the products their
loops count, exactly, and a SMOKE train step traced on a (1, 1) fake world
counts what ``FlopCounterMode`` counts around it on real tensors.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_xlstm.py
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import transformer as jax_tfm
from repro.models import xlstm as jax_xlstm
from repro.models.model import Model as JaxModel
from repro.serve.engine import BatchAccumulator as JaxAccumulator
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train import loop as jax_loop
from repro_torch import bridge, configs
from repro_torch.configs.base import TrainConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models import xlstm
from repro_torch.models.model import Model
from repro_torch.serve.engine import BatchAccumulator, ServeEngine
from repro_torch.testing import redraw_params_
from repro_torch.train import loop
from repro_torch.train import optimizer as opt
from repro_torch.train.data import SyntheticTokens

ARCH = "xlstm-1.3b"
CELL = dict(rtol=2e-5, atol=2e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = 2e-2
B, S = 2, 12
jax_forward = jax.jit(jax_tfm.forward_xlstm, static_argnums=1)
jax_prefill = jax.jit(jax_tfm.prefill_xlstm, static_argnums=1)
jax_decode = jax.jit(jax_tfm.decode_xlstm, static_argnums=1)


def _cfgs(**kw):
    kw = {"compute_dtype": "float32", **kw}
    return (jax_configs.get(ARCH, smoke=True).replace(**kw),
            configs.get(ARCH, smoke=True).replace(**kw))


@functools.lru_cache(maxsize=None)
def _tree() -> dict:
    """The SMOKE params as numpy, redrawn from seed 17."""
    _, tcfg = _cfgs()
    params = Model(tcfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    redraw_params_(params, seed=17)
    return bridge.params_to_jax(params, tcfg)


def _params(tcfg):
    tree = _tree()
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_jax(tree, tcfg, device="cpu"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(t, j, tol=LOGITS):
    np.testing.assert_allclose(_np(t), _np(j), **tol)


def _rel(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


def _mlstm_inputs(S, seed=0, Bsz=2, H=2, K=8, V=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    # gates spread over several units, so the stabiliser m moves
    return f(Bsz, H, S, K), f(Bsz, H, S, K), f(Bsz, H, S, V), 3 * f(Bsz, H, S), 3 * f(Bsz, H, S)


def _state(seed, Bsz=2, H=2, K=8, V=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bsz, H, K, V)).astype(np.float32),
            rng.standard_normal((Bsz, H, K)).astype(np.float32),
            rng.standard_normal((Bsz, H)).astype(np.float32))


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [32, 37])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
def test_mlstm_chunkwise_matches_jax(S, with_state, return_state):
    """S a multiple of the chunk (16) and ragged, from zero state or a given one."""
    inputs = _mlstm_inputs(S)
    state = _state(3) if with_state else None
    jout = jax_xlstm.mlstm_chunkwise(
        *(jnp.asarray(a) for a in inputs), chunk=16,
        state=None if state is None else tuple(jnp.asarray(s) for s in state),
        return_state=return_state)
    tout = xlstm.mlstm_chunkwise(
        *(torch.from_numpy(a) for a in inputs), chunk=16,
        state=None if state is None else tuple(torch.from_numpy(s) for s in state),
        return_state=return_state)
    if return_state:
        (th, tst), (jh, jst) = tout, jout
        for t, j in zip(tst, jst):
            _close(t, j, CELL)
    else:
        th, jh = tout, jout
    assert th.shape == (2, 2, S, 16)
    _close(th, jh, CELL)


@pytest.mark.parametrize("S", [16, 23])
def test_mlstm_chunkwise_matches_the_sequential_reference(S):
    inputs = [torch.from_numpy(a) for a in _mlstm_inputs(S, seed=4)]
    h_ref, state_ref = xlstm.mlstm_reference(*inputs)
    h, state = xlstm.mlstm_chunkwise(*inputs, chunk=8, return_state=True)
    _close(h, h_ref, CELL)
    for t, r in zip(state, state_ref):
        _close(t, r, CELL)
    jh, _ = jax_xlstm.mlstm_reference(*(jnp.asarray(a.numpy()) for a in inputs))
    _close(h_ref, jh, CELL)


def test_mlstm_step_matches_jax():
    q, k, v, i, f = (a[:, :, 0] for a in _mlstm_inputs(1, seed=5))
    state = _state(6)
    for m0 in (state[2], np.full_like(state[2], -np.inf)):  # also the initial m = -inf
        st = (state[0], state[1], m0)
        jh, jst = jax_xlstm.mlstm_step(*(jnp.asarray(a) for a in (q, k, v, i, f)),
                                       tuple(jnp.asarray(s) for s in st))
        th, tst = xlstm.mlstm_step(*(torch.from_numpy(a) for a in (q, k, v, i, f)),
                                   tuple(torch.from_numpy(s) for s in st))
        _close(th, jh, CELL)
        for t, j in zip(tst, jst):
            _close(t, j, CELL)


def _slstm_params(tcfg):
    jp, tp = _params(tcfg)
    return (jax.tree_util.tree_map(lambda a: a[0], jp["super"]["slstm"]),
            tfm.layer_params(tp["super"]["slstm"], 0))


def test_slstm_cell_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _slstm_params(tcfg)
    H, dh = xlstm.slstm_dims(tcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    given = tuple(rng.standard_normal((B, H, dh)).astype(np.float32) for _ in range(4))
    for state in (None, given):
        jst = (jax_xlstm.init_slstm_state(jcfg, B) if state is None
               else tuple(jnp.asarray(s) for s in state))
        tst = (xlstm.init_slstm_state(tcfg, B, "cpu") if state is None
               else tuple(torch.from_numpy(s) for s in state))
        jh, jfinal = jax_xlstm.slstm_cell(jp, jcfg, jnp.asarray(x), jst)
        th, tfinal = xlstm.slstm_cell(tp, tcfg, torch.from_numpy(x), tst)
        _close(th, jh, CELL)
        for t, j in zip(tfinal, jfinal):
            _close(t, j, CELL)


def _mlstm_block_params(tcfg):
    jp, tp = _params(tcfg)
    return (jax.tree_util.tree_map(lambda a: a[0, 0], jp["super"]["mlstm"]),
            tfm.layer_params(tfm.layer_params(tp["super"]["mlstm"], 0), 0))


@pytest.mark.parametrize("mode", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_matches_jax(block, mode):
    """apply_mlstm_block / apply_slstm_block without a cache, building one
    (prefill) and stepping one token against one (decode)."""
    jcfg, tcfg = _cfgs()
    jp, tp = (_mlstm_block_params if block == "mlstm" else _slstm_params)(tcfg)
    jax_fn = jax_xlstm.apply_mlstm_block if block == "mlstm" else jax_xlstm.apply_slstm_block
    fn = xlstm.apply_mlstm_block if block == "mlstm" else xlstm.apply_slstm_block
    x = np.random.default_rng(8).standard_normal((B, S + 1, tcfg.d_model)).astype(np.float32)
    jx, tx = _both(x)
    if mode == "decode":
        _, jcache = jax_fn(jp, jcfg, jx[:, :S], return_cache=True)
        _, tcache = fn(tp, tcfg, tx[:, :S], return_cache=True)
        jout, jnew = jax_fn(jp, jcfg, jx[:, S:], cache=jcache)
        tout, tnew = fn(tp, tcfg, tx[:, S:], cache=tcache)
    else:
        jout, jnew = jax_fn(jp, jcfg, jx, return_cache=mode == "prefill")
        tout, tnew = fn(tp, tcfg, tx, return_cache=mode == "prefill")
    _close(tout, jout, CELL)
    if mode == "forward":
        assert tnew is None and jnew is None
        return
    jleaves = jax.tree_util.tree_leaves_with_path(jnew)
    tleaves = jax.tree_util.tree_leaves_with_path(tnew)
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (_, t), (_, j) in zip(tleaves, jleaves):
        _close(t, j, CELL)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_bf16_block_matches_jax(block):
    """One block in bf16 (its f32 islands: the cells, the per-head norm),
    port vs jitted JAX, relative L2."""
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    jp, tp = (_mlstm_block_params if block == "mlstm" else _slstm_params)(tcfg)
    jax_fn = jax_xlstm.apply_mlstm_block if block == "mlstm" else jax_xlstm.apply_slstm_block
    fn = xlstm.apply_mlstm_block if block == "mlstm" else xlstm.apply_slstm_block
    x = np.random.default_rng(9).standard_normal((4, 40, tcfg.d_model)).astype(np.float32)
    jout = jax.jit(lambda p, x: jax_fn(p, jcfg, x)[0])(jp, jnp.asarray(x, jnp.bfloat16))
    with torch.inference_mode():
        tout, _ = fn(tp, tcfg, torch.from_numpy(x).bfloat16())
    assert tout.dtype == torch.bfloat16
    assert _rel(tout, jout) <= BF16_TOL


# ---------------------------------------------------------------------------
# tests/models/test_xlstm_regression.py's pins, on the port
# ---------------------------------------------------------------------------


def _regression_case(compute_dtype=None):
    """The minimal repro: one mLSTM block of the reference-initialised SMOKE
    model (PRNGKey(0), bridged) on the real embedding of random tokens, in
    the config's bf16 compute or in ``compute_dtype``.  Its stabiliser m falls
    to about -81 in either dtype, so the clamp of ``_denom`` is taken."""
    jcfg = jax_configs.get(ARCH, smoke=True)
    tcfg = configs.get(ARCH, smoke=True)
    if compute_dtype:
        jcfg, tcfg = (c.replace(compute_dtype=compute_dtype) for c in (jcfg, tcfg))
    jparams, _ = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                     device="cpu")
    tokens = jax.random.randint(jax.random.split(jax.random.PRNGKey(1), 3)[0], (2, 32), 0,
                                jcfg.vocab_size)
    jx0 = jax_tfm.embed_tokens(jparams, jcfg, tokens)
    tx0 = tfm.embed_tokens(tparams, tcfg, torch.from_numpy(np.array(tokens)).long())
    jblock = jax.tree_util.tree_map(lambda a: a[0, 0], jparams["super"]["mlstm"])
    tblock = tfm.layer_params(tfm.layer_params(tparams["super"]["mlstm"], 0), 0)
    return jcfg, tcfg, jblock, tblock, jx0, tx0


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_mlstm_block_grads_finite_minimal_repro(compute_dtype):
    """Finite gradients in every leaf, held against jax.grad's.  f32: each
    element within 1e-4 of its size plus 1e-4 of its leaf's RMS (the reference
    init makes these gradients hundreds, and a sum's rounding grows with its
    terms, as chip_smoke.kernel_tolerance says).  bf16 (the pin's own dtype,
    where the two round at other places): all leaves together within 2e-2
    (relative L2)."""
    jcfg, tcfg, jblock, tblock, jx0, tx0 = _regression_case(compute_dtype)
    jgrads = jax.grad(lambda p: jnp.mean(jnp.square(
        jax_xlstm.apply_mlstm_block(p, jcfg, jx0)[0])))(jblock)
    _, tgrads = L.value_and_grad(lambda p: torch.mean(torch.square(
        xlstm.apply_mlstm_block(p, tcfg, tx0)[0])), tblock)
    flat = dict(L.flatten_specs(tgrads))
    nonfinite = ["/".join(p) for p, g in flat.items() if not bool(torch.isfinite(g).all())]
    assert not nonfinite, f"non-finite grads in {nonfinite}"
    jflat = {tuple(str(k.key) for k in path): g
             for path, g in jax.tree_util.tree_leaves_with_path(jgrads)}
    assert sorted(jflat) == sorted(flat)
    if compute_dtype == "float32":
        for path, g in flat.items():
            rms = float(np.sqrt(np.mean(np.square(_np(jflat[path])))))
            _close(g, jflat[path], dict(rtol=1e-4, atol=1e-4 * max(rms, 1.0)))
    else:
        t_all = np.concatenate([_np(flat[p]).ravel() for p in sorted(flat)])
        j_all = np.concatenate([_np(jflat[p]).ravel() for p in sorted(flat)])
        assert _rel(t_all, j_all) <= BF16_TOL


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_mlstm_block_forward_is_finite(compute_dtype):
    """Finite in the pin's bf16; in f32 also within 1e-4 of the reference."""
    jcfg, tcfg, jblock, tblock, jx0, tx0 = _regression_case(compute_dtype)
    with torch.inference_mode():
        y, _ = xlstm.apply_mlstm_block(tblock, tcfg, tx0)
    assert bool(torch.isfinite(y.float()).all())
    if compute_dtype == "float32":
        _close(y, jax_xlstm.apply_mlstm_block(jblock, jcfg, jx0)[0], LOGITS)


def test_denom_floor_matches_unclamped_in_safe_range():
    den = torch.tensor([[-2.0, 0.5], [1e-3, 0.0]])
    m = torch.tensor([[-3.0, 0.0], [5.0, -80.0]])
    expected = torch.maximum(den.abs(), torch.exp(-m))
    assert torch.equal(xlstm._denom(den, m), expected)
    np.testing.assert_array_equal(
        xlstm._denom(den, m).numpy(),
        np.asarray(jax_xlstm._denom(jnp.asarray(den.numpy()), jnp.asarray(m.numpy()))))


def test_denom_floor_finite_and_differentiable_below_overflow():
    """m < -88.7 (and the initial state's m = -inf): the floor stays finite and
    its gradient is exactly zero on the clamped branch, as jax.grad gives."""
    den = torch.tensor([0.1, 0.1])
    m = torch.tensor([-500.0, -torch.inf], requires_grad=True)
    d = xlstm._denom(den, m)
    assert bool(torch.isfinite(d).all())
    (g,) = torch.autograd.grad(torch.sum(1.0 / d), m)
    assert bool(torch.isfinite(g).all()) and not g.any()
    jg = jax.grad(lambda mm: jnp.sum(1.0 / jax_xlstm._denom(jnp.asarray([0.1, 0.1]), mm)))(
        jnp.asarray([-500.0, -np.inf], jnp.float32))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


# ---------------------------------------------------------------------------
# the SMOKE model
# ---------------------------------------------------------------------------


def test_forward_and_loss_match_jax():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(tcfg)
    tokens = _tokens(tcfg, (B, S + 1))
    jlogits, _ = jax_forward(jparams, jcfg, jnp.asarray(tokens[:, :-1]))
    tlogits, aux = Model(tcfg).forward(tparams, {"tokens": torch.from_numpy(tokens[:, :-1]).long()})
    assert tlogits.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    _close(tlogits, jlogits)
    mask = (np.random.default_rng(2).random((B, S)) > 0.3).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(tokens[:, :-1]), "labels": jnp.asarray(tokens[:, 1:]),
              "loss_mask": jnp.asarray(mask)}
    tbatch = {"tokens": torch.from_numpy(tokens[:, :-1]).long(),
              "labels": torch.from_numpy(tokens[:, 1:]).long(),
              "loss_mask": torch.from_numpy(mask)}
    _close(Model(tcfg).loss(tparams, tbatch), JaxModel(jcfg).loss(jparams, jbatch))


def _check_caches(tcache, jcache):
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tleaves = jax.tree_util.tree_leaves_with_path(tcache)
    # mlstm/{C,conv,m,n} and slstm/state/(h,c,n,m)
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves] and len(tleaves) == 8
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype) == f"torch.{j.dtype}", path
        _close(t, j)


def test_prefill_matches_jax():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(tcfg)
    tokens = _tokens(tcfg, (B, S))
    jlogits, jcache = jax_prefill(jparams, jcfg, jnp.asarray(tokens))
    tlogits, tcache = Model(tcfg).prefill(tparams, {"tokens": torch.from_numpy(tokens).long()},
                                          None)
    assert tlogits.shape == (B, 1, tcfg.vocab_size)
    n_super, n_m = tfm.xlstm_structure(tcfg)
    assert tcache["mlstm"]["C"].shape[:2] == (n_super, n_m)
    _close(tlogits, jlogits)
    _check_caches(tcache, jcache)


def test_decode_matches_jax_for_8_steps():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(tcfg)
    tokens = _tokens(tcfg, (B, 5 + 8))
    _, jcache = jax_prefill(jparams, jcfg, jnp.asarray(tokens[:, :5]))
    _, tcache = tfm.prefill_xlstm(tparams, tcfg, torch.from_numpy(tokens[:, :5]).long())
    for pos in range(5, 13):
        jx, tx = _both(tokens[:, pos:pos + 1])
        jlogits, jcache = jax_decode(jparams, jcfg, jx, jcache, jnp.asarray(pos, jnp.int32))
        tlogits, tcache = Model(tcfg).decode_step(tparams, tx.long(), tcache, pos)
        _close(tlogits, jlogits)
    _check_caches(tcache, jcache)


def test_init_cache_matches_jax():
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    jcache = JaxModel(jcfg).init_cache(3, 10)
    tcache = Model(tcfg).init_cache(3, 10, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tleaves = jax.tree_util.tree_leaves_with_path(tcache)
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}", path
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))


# tests/models/test_decode.py:49-73, on the port, at the reference's tolerance there
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("prefill", [0, 5])
def test_decode_matches_forward(prefill):
    """Token by token from the empty cache, or from a 5-token prefill: each
    step's logits are the teacher-forced forward's at that position."""
    _, tcfg = _cfgs()
    _, tparams = _params(tcfg)
    model = Model(tcfg)
    tokens = torch.from_numpy(_tokens(tcfg, (B, 8), seed=4)).long()
    full, _ = model.forward(tparams, {"tokens": tokens})
    if prefill:
        logits, cache = model.prefill(tparams, {"tokens": tokens[:, :prefill]}, 8)
        _close(logits[:, 0], full[:, prefill - 1], DECODE_TOL)
    else:
        cache = model.init_cache(B, 8, device="cpu")
    for t in range(prefill, 8):
        logits, cache = model.decode_step(tparams, tokens[:, t:t + 1], cache, t)
        _close(logits[:, 0], full[:, t], DECODE_TOL)


def _serve(engine_cls, accum_cls, model, params, prompts, eos, **kw):
    engine = engine_cls(model, params, max_len=24, eos_token=eos, **kw)
    accum = accum_cls(engine, max_batch=3)
    for p in prompts:
        accum.submit(p)
    return accum.flush(max_new_tokens=8), engine.stats


def test_serve_engine_tokens_identical_to_jax():
    """Greedy serving of ragged, left-padded prompts, with and without EOS."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab_size, n) for n in (5, 9, 3, 12, 7)]
    jax_side = (JaxEngine, JaxAccumulator, JaxModel(jcfg), jparams, prompts)
    port_side = (ServeEngine, BatchAccumulator, Model(tcfg), tparams, prompts)
    ref, _ = _serve(*port_side, None, device="cpu")
    eos = int(ref[0]["tokens"][2])  # ends request 0 after 3 tokens
    for eos_token in (None, eos):
        jout, jstats = _serve(*jax_side, eos_token)
        tout, tstats = _serve(*port_side, eos_token, device="cpu")
        assert tstats == jstats and len(tout) == len(jout) == len(prompts)
        for t, j in zip(tout, jout):
            assert t["prompt_len"] == j["prompt_len"]
            np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert (tout[0]["tokens"][3:] == eos).all()


def test_train_step_matches_reference():
    """One make_train_step from the same bridged weights on the same batch:
    loss at 1e-4, gradient norm at 1e-3, every gradient finite (the
    _denom clamp's backward)."""
    jcfg, tcfg = _cfgs(remat_policy="full")
    tc = dict(total_steps=10, warmup_steps=1, learning_rate=1e-3)
    j_state, _ = jax_loop.init_state(JaxModel(jcfg), jax.random.PRNGKey(0))
    j_state = j_state._replace(params=jax.tree_util.tree_map(jnp.asarray, _tree()))
    t_params = bridge.params_from_jax(_tree(), tcfg, device="cpu")
    t_state = loop.TrainState(t_params, opt.init_adamw(t_params))
    batch = SyntheticTokens(tcfg.vocab_size, 2, 16, seed=0).batch_at(0)
    _, j_m = jax.jit(jax_loop.make_train_step(JaxModel(jcfg), JaxTrainConfig(**tc)))(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()})
    _, t_m = loop.make_train_step(Model(tcfg), TrainConfig(**tc))(
        t_state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(t_m["loss"]) - float(j_m["loss"])) <= 1e-4 * abs(float(j_m["loss"]))
    assert abs(float(t_m["grad_norm"]) - float(j_m["grad_norm"])) <= (
        1e-3 * abs(float(j_m["grad_norm"])))
    assert np.isfinite(float(t_m["grad_norm"]))
    for _, p in L.flatten_specs(t_state.params):
        assert bool(torch.isfinite(p).all())


def test_bridge_round_trips_xlstm_bitwise():
    """mLSTM leaves stacked twice [n_super, n_m, ...], sLSTM once, in
    jax.tree_util's order."""
    _, tcfg = _cfgs()
    jparams, tparams = _params(tcfg)
    n_super, n_m = tfm.xlstm_structure(tcfg)
    assert tparams["super"]["mlstm"]["wq"].shape[:2] == (n_super, n_m)
    assert tparams["super"]["slstm"]["r_z"].shape[0] == n_super
    back = bridge.params_to_jax(tparams, tcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    bleaves = jax.tree_util.tree_leaves_with_path(back)
    assert len(jleaves) == len(bleaves) == 33
    for (jp, j), (bp, b) in zip(jleaves, bleaves):
        assert jp == bp and b.dtype == j.dtype
        np.testing.assert_array_equal(b, np.asarray(j))


# ---------------------------------------------------------------------------
# the two loops as ops: gradient and FLOPs
# ---------------------------------------------------------------------------


def _slstm_inputs(seed, Bsz=2, S_=9, H=2, dh=8, given_state=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    wx = tuple(f(Bsz, S_, H, dh) for _ in range(4))
    R = tuple(0.5 * f(H, dh, dh) for _ in range(4))
    if given_state:
        state = (f(Bsz, H, dh), f(Bsz, H, dh), f(Bsz, H, dh).abs() + 0.5, f(Bsz, H, dh))
    else:
        zero = torch.zeros(Bsz, H, dh)
        state = (zero, zero, zero, torch.full((Bsz, H, dh), -torch.inf))
    return wx, R, state


@pytest.mark.parametrize("given_state", [False, True])
def test_slstm_scan_gradient_equals_autograd_through_the_steps(given_state):
    """rtol = atol = 2e-5: the op's backward (by hand through time, from the
    pre-activations its forward saved) against autograd through
    :func:`xlstm._slstm_steps`, for an upstream gradient on all four stacked
    outputs, from the zero state (n = 1 ties torch.maximum at the first
    step, m = -inf) and from a given one."""
    wx, R, state = _slstm_inputs(11, given_state=given_state)
    leaves = [t.clone().requires_grad_() for t in (*wx, *R, *state)]
    gen = torch.Generator().manual_seed(2)
    ups = [torch.randn(wx[0].shape, generator=gen) for _ in range(4)]

    def grads(fn):
        outs = fn(tuple(leaves[:4]), tuple(leaves[4:8]), tuple(leaves[8:]))
        return torch.autograd.grad(outs, leaves, ups, allow_unused=True, materialize_grads=True)

    got = grads(xlstm.slstm_scan)
    want = grads(xlstm._slstm_steps)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, **CELL)


@pytest.mark.parametrize("S", [32, 37])
@pytest.mark.parametrize("given_state", [False, True])
def test_mlstm_chunkwise_gradient_equals_autograd_through_the_chunks(S, given_state):
    """rtol 2e-5 and atol 2e-5 or 1e-6 of the gradient's largest entry: the
    op's backward (by hand through the chunks, from the states and products
    its forward saved) against autograd through :func:`xlstm._mlstm_chunks`,
    for an upstream gradient on h and the final state, S a multiple of the
    chunk (16) and ragged, from the zero state (m = -inf) and from a given
    one.  The gates' spread makes gradients of several hundred, whose f32
    sums differ by their order: both differ from a float64 gradient by
    about 1e-5 of that scale, and from each other by well under 1e-6 of it."""
    inputs = _mlstm_inputs(S, seed=9)
    state = (_state(10) if given_state
             else tuple(t.numpy() for t in xlstm.initial_mlstm_state(2, 2, 8, 16, "cpu")))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (*inputs, *state)]
    gen = torch.Generator().manual_seed(3)
    ups = [torch.randn(shape, generator=gen) for shape in ((2, 2, S, 16), (2, 2, 8, 16),
                                                            (2, 2, 8), (2, 2))]

    def grads(fn):
        h, final = fn(*leaves[:5], tuple(leaves[5:]))
        return torch.autograd.grad((h, *final), leaves, ups, allow_unused=True,
                                   materialize_grads=True)

    got = grads(lambda *a: xlstm.mlstm_chunkwise(*a[:5], chunk=16, state=a[5],
                                                 return_state=True))
    want = grads(lambda *a: xlstm._mlstm_chunks(*a[:5], 16, a[5]))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=2e-5, atol=max(2e-5, 1e-6 * float(w.abs().max())))


def test_slstm_cell_gradient_matches_jax():
    """rtol = atol = 1e-4: the gradient of a weighted sum of the sLSTM's
    outputs (h over time and the final state) with respect to the input,
    the gate weights and the given state, the port's op against
    ``jax.grad`` through the reference's ``lax.scan``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _slstm_params(tcfg)
    H, dh = xlstm.slstm_dims(tcfg)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    state = tuple(rng.standard_normal((B, H, dh)).astype(np.float32) for _ in range(4))
    wh = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    ws = tuple(rng.standard_normal((B, H, dh)).astype(np.float32) for _ in range(4))
    names = ("w_z", "r_i", "b_f")

    def jloss(sub, x, st):
        p = {**jp, **sub}
        h, final = jax_xlstm.slstm_cell(p, jcfg, x, st)
        return jnp.sum(h * wh) + sum(jnp.sum(f * w) for f, w in zip(final, ws))

    jg = jax.grad(jloss, argnums=(0, 1, 2))({k: jp[k] for k in names}, jnp.asarray(x),
                                            tuple(jnp.asarray(s) for s in state))
    sub = {k: tp[k].clone().requires_grad_() for k in names}
    tx = torch.from_numpy(x).requires_grad_()
    tst = tuple(torch.from_numpy(s).requires_grad_() for s in state)
    h, final = xlstm.slstm_cell({**tp, **sub}, tcfg, tx, tst)
    loss = (h * torch.from_numpy(wh)).sum() + sum((f * torch.from_numpy(w)).sum()
                                                  for f, w in zip(final, ws))
    tg = torch.autograd.grad(loss, [*sub.values(), tx, *tst])
    want = [jg[0][k] for k in names] + [jg[1], *jg[2]]
    for g, w in zip(tg, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_loop_ops_count_the_products_of_their_loops():
    """Exact: ``FlopCounterMode`` counts each op by its formula, and the
    formula is what the plain loop's products count, forward and backward.
    A backward runs no product of its forward again: it runs two products
    for each of the forward's, but for the mLSTM's q n0 and n update, whose
    gradients are in part outer products and broadcasts (6 Q K a chunk
    fewer).  The sLSTM split over 2 ranks a head counts a rank's columns:
    half the whole head's products."""
    from torch.utils.flop_counter import FlopCounterMode

    def count(fn, *a):
        with FlopCounterMode(display=False) as counter:
            out = fn(*a)
        return counter.get_total_flops(), out

    q, k, v, i, f = (torch.from_numpy(a) for a in _mlstm_inputs(37))
    st = xlstm.initial_mlstm_state(2, 2, 8, 16, "cpu")
    saved = []
    plain, (h, final) = count(xlstm._mlstm_chunks, q, k, v, i, f, 16, st, saved)
    op, outs = count(torch.ops.repro_torch.mlstm_chunkwise, q, k, v, i, f, *st, 16, True)
    assert op == plain
    residuals = [torch.stack(t, dim=2) for t in zip(*saved)]
    for got, want in zip(outs, (h, *final, *residuals)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    ups = (torch.ones_like(h), *(torch.ones_like(t) for t in final))
    plain_back = count(xlstm._mlstm_chunks_backward, q, k, v, i, f, 16, residuals, *ups)[0]
    back = count(torch.ops.repro_torch.mlstm_chunkwise_backward, q, k, v, i, f, *residuals, 16,
                 *ups)[0]
    nc, Q, K = 3, 16, 8
    assert back == plain_back == 2 * plain - 2 * 2 * nc * 6 * Q * K

    wx, R, state = _slstm_inputs(12)
    pre = []
    plain, stacks = count(xlstm._slstm_steps, wx, R, state, pre)
    op, outs = count(torch.ops.repro_torch.slstm_scan, *wx, *R, *state, "", True)
    assert op == plain
    pre = tuple(torch.stack(p, dim=1) for p in zip(*pre))
    ups = tuple(torch.ones_like(s) for s in stacks)
    plain_back = count(xlstm._slstm_steps_backward, R, state, pre, stacks, ups)[0]
    back = count(torch.ops.repro_torch.slstm_scan_backward, *R, *state, *stacks,
                 torch.stack(pre), outs[5], *ups, "")[0]
    assert back == plain_back == 2 * plain

    # split over a group of 2 ranks a head: a rank's 4 of each head's 8
    # columns, whose products read the whole h_prev (fake tensors: the
    # group's collectives run in the op's real implementation alone)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        cols = [t[..., :4] for t in (*wx, *R, *state)]
        split, souts = count(torch.ops.repro_torch.slstm_scan, *cols, "run", True)
        split_back = count(torch.ops.repro_torch.slstm_scan_backward, *cols[4:], *souts,
                           *(torch.ones_like(s) for s in souts[:4]), "run")[0]
    assert split == plain // 2 and split_back == 2 * split
    assert souts[4].shape == (4, *cols[0].shape) and souts[5].shape == wx[0].shape


def test_train_step_flops_equal_flop_counter_on_real_tensors(monkeypatch):
    """Exact: a SMOKE xLSTM train step traced on a fake (1, 1) world counts
    the FLOPs ``FlopCounterMode`` counts around the same step run on real
    CPU tensors without DTensor (each loop op and its backward by its
    formula), as ``tests/test_torch_dryrun.py`` (e) holds internlm2's."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    shape = ShapeConfig("train_4k", "train", seq_len=32, global_batch=4)
    get = configs.get
    monkeypatch.setattr(configs, "get", lambda arch, smoke=True: get(arch, smoke=True))
    rec = dryrun.run_cell(ARCH, "train_4k", "single", device="cpu", shape=shape,
                          mesh_shape=(1, 1), save=False)
    assert rec["status"] == "ok", rec.get("traceback")

    cfg = configs.get(ARCH, smoke=True)
    model = Model(cfg)
    state = loop.init_state(model, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (shape.global_batch, shape.seq_len))
    step = loop.make_train_step(model, TrainConfig())
    with FlopCounterMode(display=False) as counter:
        step(state, {"tokens": tokens, "labels": tokens})
    assert counter.get_total_flops() > 0
    assert rec["cost"]["flops"] == counter.get_total_flops()
