"""The port's layers against ``repro.models.layers`` / ``attention``, in f32.

Inputs and weights are made from seeded numpy and handed to both packages;
the reference's f32 tolerance (2e-5) applies throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest

# the port's tests need torch beside jax; without it they are not collected
torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.models import attention as jax_attn
from repro.models import layers as jax_L
from repro_torch import configs
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

TOL = dict(rtol=2e-5, atol=2e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _both(tree):
    """The same numpy tree as JAX arrays and as torch tensors."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(tree)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("norm_type,bias", [("rmsnorm", False), ("layernorm", False),
                                            ("layernorm", True)])
def test_norm(norm_type, bias):
    rng = _rng(1)
    p = {"scale": rng.standard_normal(32).astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(32).astype(np.float32)
    (jp, tp), (jx, tx) = _both(p), _both(3 * rng.standard_normal((2, 5, 32)).astype(np.float32))
    _close(L.apply_norm(tp, tx, norm_type, 1e-5), jax_L.apply_norm(jp, jx, norm_type, 1e-5))


@pytest.mark.parametrize("positions_shape", ["1d", "2d"])
def test_rope_at_offset_positions(positions_shape):
    rng = _rng(2)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.arange(37, 43, dtype=np.int32)
    if positions_shape == "2d":
        pos = np.stack([pos, pos + 100])
    (jx, tx), (jp, tp) = _both(x), _both(pos)
    _close(L.apply_rope(tx, tp, 1e6), jax_L.apply_rope(jx, jp, 1e6))


def test_dense_with_bias():
    rng = _rng(3)
    p = {"w": rng.standard_normal((32, 48)).astype(np.float32),
         "b": rng.standard_normal(48).astype(np.float32)}
    (jp, tp), (jx, tx) = _both(p), _both(rng.standard_normal((2, 5, 32)).astype(np.float32))
    _close(L.apply_dense(tp, tx), jax_L.apply_dense(jp, jx))


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_unembed(softcap):
    rng = _rng(4)
    p = {"table": 4 * rng.standard_normal((64, 32)).astype(np.float32)}
    (jp, tp), (jx, tx) = _both(p), _both(rng.standard_normal((2, 3, 32)).astype(np.float32))
    _close(L.apply_unembed(tp, tx, softcap), jax_L.apply_unembed(jp, jx, softcap))


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp(mlp_type):
    rng = _rng(5)
    names = ("gate", "up", "down") if mlp_type == "swiglu" else ("up", "down")
    p = {n: {"w": (rng.standard_normal((48, 32) if n == "down" else (32, 48))
                   / 6).astype(np.float32)} for n in names}
    (jp, tp), (jx, tx) = _both(p), _both(rng.standard_normal((2, 5, 32)).astype(np.float32))
    _close(L.apply_mlp(tp, tx, mlp_type), jax_L.apply_mlp(jp, jx, mlp_type))


def test_embedding():
    rng = _rng(6)
    (jp, tp) = _both({"table": rng.standard_normal((64, 32)).astype(np.float32)})
    tokens = rng.integers(0, 64, (2, 7)).astype(np.int32)
    _close(L.apply_embedding(tp, torch.from_numpy(tokens).long(), torch.float32),
           jax_L.apply_embedding(jp, jnp.asarray(tokens), jnp.float32))


@pytest.mark.parametrize("window,softcap", [(None, None), (3, None), (None, 30.0)])
def test_attend_xla_with_cache_mask(window, softcap):
    """The decode path's attention: offset query positions over a partly
    valid cache."""
    rng = _rng(7)
    q = rng.standard_normal((2, 2, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 10, 2, 16)).astype(np.float32) for _ in range(2))
    qpos = np.array([[6, 7], [6, 7]], np.int32)
    kpos = np.arange(10, dtype=np.int32)
    valid = np.broadcast_to(kpos[None] < 8, (2, 10)).copy()
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    kw = dict(causal=True, window=window, logit_softcap=softcap)
    out = attn.attend_xla(tq, tk, tv, q_positions=torch.from_numpy(qpos),
                          kv_positions=torch.from_numpy(kpos),
                          kv_valid=torch.from_numpy(valid), **kw)
    expected = jax_attn.attend_xla(jq, jk, jv, q_positions=jnp.asarray(qpos),
                                   kv_positions=jnp.asarray(kpos),
                                   kv_valid=jnp.asarray(valid), **kw)
    _close(out, expected)


def test_init_specs_match_reference_shapes():
    """ParamSpec trees give the reference's shapes, initialisers and scales."""
    cfg = jax_configs.get("starcoder2-15b", smoke=True)
    tcfg = configs.get("starcoder2-15b", smoke=True)
    jspec = jax_attn.init_attention(cfg)
    tspec = attn.init_attention(tcfg)
    for name in jspec:
        for leaf in jspec[name]:
            j, t = jspec[name][leaf], tspec[name][leaf]
            assert (t.shape, t.init, t.scale) == (j.shape, j.init, j.scale)


def test_materialize_truncated_normal_statistics():
    gen = torch.Generator("cpu").manual_seed(0)
    params = L.materialize(gen, {"w": L.ParamSpec((400, 300), ("embed", "mlp"), scale=2.0),
                                 "s": L.ParamSpec((300,), ("mlp",), init="ones")},
                           torch.float32, "cpu")
    w = params["w"]
    std = 2.0 / np.sqrt(400)
    assert w.abs().max() <= 3 * std + 1e-6
    # std of a standard normal truncated at +-3 is 0.9866
    assert abs(w.std().item() / std - 0.9866) < 0.01
    assert torch.equal(params["s"], torch.ones(300))
