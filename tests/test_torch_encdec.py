"""The port's enc-dec family (whisper-medium) against the JAX package, at SMOKE
sizes.

Weights are redrawn from a seed by :func:`repro_torch.testing.redraw_params_`
(biases and layer-norm gains included) and cross to the JAX package through
the bridge; inputs (frames, tokens) are seeded numpy.  The JAX side under
``"flash"`` runs its Pallas kernel in interpret mode, the port's the kernel's
plain version (``attention_ref``).  Tolerances are the reference's: one
attention layer in f32 at rtol = atol = 2e-5, logits at the end of the stack
at 1e-4, one bf16 layer at 2e-2 (relative L2).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_encdec.py
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import attention as jax_attn
from repro.models import encdec as jax_encdec
from repro.models.model import Model as JaxModel
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train import loop as jax_loop
from repro_torch import bridge, configs
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine
from repro_torch.testing import redraw_params_
from repro_torch.train import loop
from repro_torch.train import optimizer as opt

ARCH = "whisper-medium"
LAYER = dict(rtol=2e-5, atol=2e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = 2e-2
B, S, S_ENC = 2, 10, 24
jax_forward = jax.jit(jax_encdec.forward_encdec, static_argnums=1)
jax_prefill = jax.jit(jax_encdec.prefill_encdec, static_argnums=1)
jax_decode = jax.jit(jax_encdec.decode_encdec, static_argnums=1)


def _cfgs(**kw):
    kw = {"compute_dtype": "float32", "attention_impl": "flash", **kw}
    return (jax_configs.get(ARCH, smoke=True).replace(**kw),
            configs.get(ARCH, smoke=True).replace(**kw))


@functools.lru_cache(maxsize=None)
def _tree() -> dict:
    """The SMOKE params as numpy, redrawn from seed 19."""
    _, tcfg = _cfgs()
    params = Model(tcfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    redraw_params_(params, seed=19)
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


def _frames(cfg, b=B, s=S_ENC, seed=2):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _layer(jtree, ttree, name, i=0):
    return (jax.tree_util.tree_map(lambda a: a[i], jtree[name]),
            tfm.layer_params(ttree[name], i))


# ---------------------------------------------------------------------------
# the attention pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length,dim", [(24, 64), (1500, 1024)])
def test_sinusoidal_positions_match_jax(length, dim):
    """At whisper's 1500 frames the angles reach 1499 rad, where one f32 ulp of
    the angle (1.2e-4) moves sin and cos by as much: the two packages' exp
    may differ in the last bit of a timescale.  So atol is one ulp of the
    largest angle, 2e-5 at least."""
    tol = dict(rtol=2e-5, atol=max(2e-5, length * 2.0 ** -23))
    _close(encdec.sinusoidal_positions(length, dim), jax_encdec.sinusoidal_positions(length, dim),
           tol)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_bidirectional_attention_matches_jax(impl, monkeypatch):
    """apply_attention(causal=False, use_rope=False), the encoder's, through
    the kernel entry point ("flash", which takes attention_ref here) and
    attend_xla, against JAX's; "flash" calls the entry point with causal=False."""
    jcfg, tcfg = _cfgs(attention_impl=impl)
    jparams, tparams = _params(tcfg)
    jp, tp = _layer(jparams, tparams, "encoder")
    x = _frames(tcfg, seed=3)
    positions = np.arange(S_ENC)
    calls = []
    real = attn.kernel_ops.flash_attention
    monkeypatch.setattr(attn.kernel_ops, "flash_attention",
                        lambda *a, **kw: calls.append(kw["causal"]) or real(*a, **kw))
    jout, _ = jax_attn.apply_attention(jp["attn"], jcfg, jnp.asarray(x), jnp.asarray(positions),
                                       causal=False, use_rope=False)
    tout, _ = attn.apply_attention(tp["attn"], tcfg, torch.from_numpy(x),
                                   torch.from_numpy(positions), causal=False, use_rope=False)
    _close(tout, jout, LAYER)
    assert calls == ([False] if impl == "flash" else [])


def test_cross_attention_matches_jax():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(tcfg)
    jp, tp = _layer(jparams, tparams, "decoder", 1)
    enc = _frames(tcfg, seed=4)
    x = _frames(tcfg, s=S, seed=5)
    jkv = jax_attn.precompute_cross_kv(jp["cross_attn"], jcfg, jnp.asarray(enc))
    tkv = attn.precompute_cross_kv(tp["cross_attn"], tcfg, torch.from_numpy(enc))
    for key in ("k", "v"):
        assert tuple(tkv[key].shape) == jkv[key].shape == (B, S_ENC, tcfg.n_kv_heads,
                                                         tcfg.resolved_head_dim)
        _close(tkv[key], jkv[key], LAYER)
    jout = jax_attn.apply_cross_attention(jp["cross_attn"], jcfg, jnp.asarray(x), jkv)
    tout = attn.apply_cross_attention(tp["cross_attn"], tcfg, torch.from_numpy(x), tkv)
    _close(tout, jout, LAYER)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_bf16_encoder_layer_matches_jax(impl):
    """One encoder block in bf16, port vs jitted JAX (relative L2)."""
    jcfg, tcfg = _cfgs(attention_impl=impl, compute_dtype="bfloat16")
    jparams, tparams = _params(tcfg)
    jp, tp = _layer(jparams, tparams, "encoder")
    x = _frames(tcfg, b=4, s=40, seed=6)
    jout = jax.jit(lambda p, x: jax_encdec._enc_block(p, jcfg, x))(jp, jnp.asarray(x, jnp.bfloat16))
    with torch.inference_mode():
        tout = encdec._enc_block(tp, tcfg, torch.from_numpy(x).bfloat16())
    assert tout.dtype == torch.bfloat16
    assert _rel(tout, jout) <= BF16_TOL


# ---------------------------------------------------------------------------
# the SMOKE model
# ---------------------------------------------------------------------------


def _batch(tcfg, s=S):
    frames, tokens = _frames(tcfg), _tokens(tcfg, (B, s + 1))
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens[:, :-1]),
              "labels": jnp.asarray(tokens[:, 1:])}
    tbatch = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens[:, :-1]).long(),
              "labels": torch.from_numpy(tokens[:, 1:]).long()}
    return jbatch, tbatch


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_encode_and_forward_match_jax(impl):
    jcfg, tcfg = _cfgs(attention_impl=impl)
    jparams, tparams = _params(tcfg)
    jbatch, tbatch = _batch(tcfg)
    _close(encdec.encode(tparams, tcfg, tbatch["frames"]),
           jax_encdec.encode(jparams, jcfg, jbatch["frames"]))
    jlogits, _ = jax_forward(jparams, jcfg, jbatch["frames"], jbatch["tokens"])
    tlogits, aux = Model(tcfg).forward(tparams, tbatch)
    assert tlogits.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    _close(tlogits, jlogits)


def test_loss_matches_jax():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(tcfg)
    jbatch, tbatch = _batch(tcfg)
    mask = (np.random.default_rng(2).random((B, S)) > 0.3).astype(np.float32)
    _close(Model(tcfg).loss(tparams, tbatch), JaxModel(jcfg).loss(jparams, jbatch))
    jbatch["loss_mask"], tbatch["loss_mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    _close(Model(tcfg).loss(tparams, tbatch), JaxModel(jcfg).loss(jparams, jbatch))


def _check_caches(tcache, jcache):
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tleaves = jax.tree_util.tree_leaves_with_path(tcache)
    # cross_kv/{k,v}, self/{k,v}
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves] and len(tleaves) == 4
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype) == f"torch.{j.dtype}", path
        _close(t, j)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_prefill_and_decode_match_jax(impl):
    """Prefill (encoder, cross K/V, the 32-long self cache) and 8 decode steps."""
    jcfg, tcfg = _cfgs(attention_impl=impl)
    jparams, tparams = _params(tcfg)
    frames, tokens = _frames(tcfg), _tokens(tcfg, (B, 5 + 8))
    jlogits, jcache = jax_prefill(jparams, jcfg, jnp.asarray(frames), jnp.asarray(tokens[:, :5]))
    tlogits, tcache = Model(tcfg).prefill(
        tparams, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens[:, :5]).long()},
        None)
    assert tlogits.shape == (B, 1, tcfg.vocab_size)
    _close(tlogits, jlogits)
    _check_caches(tcache, jcache)
    for pos in range(5, 13):
        new = tokens[:, pos:pos + 1]
        jlogits, jcache = jax_decode(jparams, jcfg, jnp.asarray(new), jcache,
                                     jnp.asarray(pos, jnp.int32))
        tlogits, tcache = Model(tcfg).decode_step(tparams, torch.from_numpy(new).long(), tcache,
                                                  pos)
        _close(tlogits, jlogits)
    _check_caches(tcache, jcache)


def test_init_cache_matches_jax():
    """``max_len`` is the encoder length; the self cache is max_target_positions."""
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    jcache = JaxModel(jcfg).init_cache(3, S_ENC)
    tcache = Model(tcfg).init_cache(3, S_ENC, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    tleaves = jax.tree_util.tree_leaves_with_path(tcache)
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}", path
        assert not t.any()
    assert tcache["self"]["k"].shape[2] == tcfg.max_target_positions


def test_prefill_then_decode_matches_forward():
    """tests/models/test_decode.py:76, on the port, at its tolerance."""
    _, tcfg = _cfgs()
    _, tparams = _params(tcfg)
    model = Model(tcfg)
    frames = torch.from_numpy(_frames(tcfg, seed=7))
    tokens = torch.from_numpy(_tokens(tcfg, (B, 8), seed=8)).long()
    full, _ = model.forward(tparams, {"frames": frames, "tokens": tokens})
    tol = dict(rtol=2e-3, atol=2e-3)
    logits, cache = model.prefill(tparams, {"frames": frames, "tokens": tokens[:, :4]}, None)
    _close(logits[:, 0], full[:, 3], tol)
    for t in range(4, 8):
        logits, cache = model.decode_step(tparams, tokens[:, t:t + 1], cache, t)
        _close(logits[:, 0], full[:, t], tol)


def test_decode_past_max_target_positions_clamps_as_jax():
    """At position >= max_target_positions (32 at SMOKE, 448 at full size)
    JAX's dynamic slices clamp: the position embedding reads the last row and
    the cache write lands on the last slot.  The port reproduces it."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(tcfg)
    P = tcfg.max_target_positions
    frames, tokens = _frames(tcfg), _tokens(tcfg, (B, P + 3))
    jlogits, jcache = jax_prefill(jparams, jcfg, jnp.asarray(frames), jnp.asarray(tokens[:, :P - 2]))
    tlogits, tcache = encdec.prefill_encdec(tparams, tcfg, torch.from_numpy(frames),
                                            torch.from_numpy(tokens[:, :P - 2]).long())
    for pos in range(P - 2, P + 3):  # 30, 31, then 32, 33, 34 past the end
        new = tokens[:, pos:pos + 1]
        jlogits, jcache = jax_decode(jparams, jcfg, jnp.asarray(new), jcache,
                                     jnp.asarray(pos, jnp.int32))
        tlogits, tcache = encdec.decode_encdec(tparams, tcfg, torch.from_numpy(new).long(),
                                               tcache, pos)
        assert bool(torch.isfinite(tlogits).all())
        _close(tlogits, jlogits)
    _check_caches(tcache, jcache)
    x = encdec._dec_embed(tparams, tcfg, torch.from_numpy(tokens[:, :1]).long(), P + 5)
    _close(x, jax_encdec._dec_embed(jparams, jcfg, jnp.asarray(tokens[:, :1]), P + 5), LAYER)


def test_serve_engine_generate_frames_tokens_identical_to_jax():
    """ServeEngine.generate(frames=) greedy, with and without EOS, at the
    engine's default max_len (prefill ignores it for enc-dec)."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(tcfg)
    frames, prompts = _frames(tcfg, b=3, seed=9), _tokens(tcfg, (3, 4), seed=10)
    ref = ServeEngine(Model(tcfg), tparams, device="cpu").generate(prompts, 6, frames=frames)
    eos = int(ref["tokens"][0, 2])
    for eos_token in (None, eos):
        jengine = JaxEngine(JaxModel(jcfg), jparams, eos_token=eos_token)
        tengine = ServeEngine(Model(tcfg), tparams, eos_token=eos_token, device="cpu")
        jout = jengine.generate(prompts, 6, frames=frames)
        tout = tengine.generate(prompts, 6, frames=frames)
        assert tengine.stats == jengine.stats and tout["prompt_len"] == jout["prompt_len"]
        np.testing.assert_array_equal(tout["tokens"], jout["tokens"])
    assert (tout["tokens"][0, 3:] == eos).all()


def test_train_step_matches_reference():
    """One make_train_step (attention "xla", as training runs) from the same
    bridged weights on the same batch: loss at 1e-4, gradient norm at 1e-3."""
    jcfg, tcfg = _cfgs(attention_impl="xla", remat_policy="full")
    tc = dict(total_steps=10, warmup_steps=1, learning_rate=1e-3)
    j_state, _ = jax_loop.init_state(JaxModel(jcfg), jax.random.PRNGKey(0))
    j_state = j_state._replace(params=jax.tree_util.tree_map(jnp.asarray, _tree()))
    t_params = bridge.params_from_jax(_tree(), tcfg, device="cpu")
    t_state = loop.TrainState(t_params, opt.init_adamw(t_params))
    jbatch, tbatch = _batch(tcfg)
    _, j_m = jax.jit(jax_loop.make_train_step(JaxModel(jcfg), JaxTrainConfig(**tc)))(j_state, jbatch)
    _, t_m = loop.make_train_step(Model(tcfg), TrainConfig(**tc))(t_state, tbatch)
    assert abs(float(t_m["loss"]) - float(j_m["loss"])) <= 1e-4 * abs(float(j_m["loss"]))
    assert abs(float(t_m["grad_norm"]) - float(j_m["grad_norm"])) <= (
        1e-3 * abs(float(j_m["grad_norm"])))
    for _, p in L.flatten_specs(t_state.params):
        assert bool(torch.isfinite(p).all())


def test_forward_calls_flash_once_per_layer(monkeypatch):
    """Under "flash" the forward sends every encoder layer's attention to the
    kernel entry point with causal=False and every decoder self-attention
    with causal=True (cross-attention stays attend_xla); prefill does too
    (the decoder's through the empty-cache route), decode never.  On CPU
    tensors the entry point counts no launch."""
    calls = []
    real = attn.kernel_ops.flash_attention

    def spy(*args, **kw):
        calls.append(kw["causal"])
        return real(*args, **kw)

    monkeypatch.setattr(attn.kernel_ops, "flash_attention", spy)
    _, tcfg = _cfgs()
    _, tparams = _params(tcfg)
    model = Model(tcfg)
    _, tbatch = _batch(tcfg)
    before = fa_kernel.flash_attention.launches
    model.forward(tparams, tbatch)
    assert len(calls) == tcfg.n_encoder_layers + tcfg.n_layers
    assert calls.count(False) == tcfg.n_encoder_layers
    assert calls[:tcfg.n_encoder_layers] == [False] * tcfg.n_encoder_layers
    calls.clear()
    _, cache = model.prefill(tparams, tbatch, None)
    assert calls == [False] * tcfg.n_encoder_layers + [True] * tcfg.n_layers
    model.decode_step(tparams, tbatch["tokens"][:, :1], cache, S)
    assert len(calls) == tcfg.n_encoder_layers + tcfg.n_layers
    Model(tcfg.replace(attention_impl="xla")).forward(tparams, tbatch)
    assert len(calls) == tcfg.n_encoder_layers + tcfg.n_layers
    assert fa_kernel.flash_attention.launches == before


def test_bridge_round_trips_whisper_bitwise():
    """Encoder and decoder stacked [L, ...], learned positions, biases, in
    jax.tree_util's order."""
    _, tcfg = _cfgs()
    jparams, tparams = _params(tcfg)
    assert tparams["encoder"]["attn"]["wq"]["b"].shape[0] == tcfg.n_encoder_layers
    assert tparams["pos_embed"].shape == (tcfg.max_target_positions, tcfg.d_model)
    back = bridge.params_to_jax(tparams, tcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    bleaves = jax.tree_util.tree_leaves_with_path(back)
    assert len(jleaves) == len(bleaves)
    for (jp, j), (bp, b) in zip(jleaves, bleaves):
        assert jp == bp and b.dtype == j.dtype
        np.testing.assert_array_equal(b, np.asarray(j))
