"""The port's zamba2 (hybrid) slice against the JAX package, at SMOKE sizes.

Weights are redrawn from a seed by :func:`repro_torch.testing.redraw_params_`
(whose docstring says why the reference's own init is not used) and cross
to the JAX package through the bridge.  Token inputs are seeded numpy.  The
JAX forward under ``"flash"`` runs its Pallas scan in interpret mode.  Logits are compared in f32 at rtol = atol = 1e-4, as in
``tests/test_torch_serve.py``.  Token arrays must be identical.

Run as a script, the file prints the bf16 distances that set
``chip_smoke.py``'s limit for the first super-block:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_zamba.py
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tfm
from repro.models.model import Model as JaxModel
from repro.serve.engine import BatchAccumulator as JaxAccumulator
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train.loop import make_eval_step as jax_make_eval_step
from repro_torch import bridge, configs
from repro_torch.kernels import mamba_scan as ms_kernel
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.serve.engine import BatchAccumulator, ServeEngine
from repro_torch.testing import redraw_params_
from repro_torch.train.loop import make_eval_step

ARCH = "zamba2-7b"
# f32 logits, both routes.  The port's flash forward on the CPU runs the
# sequential recurrence (mamba_scan_ref), JAX's the chunked Pallas kernel in
# interpret mode; with the weights of redraw_params_ the two sit 1.6e-5 apart
# (max |diff|; the "xla" routes 1.8e-5), well inside.  main() prints both.
TOL = dict(rtol=1e-4, atol=1e-4)
# bf16, one Mamba2 layer, port vs JAX (relative L2)
BF16_TOL = 2e-2
B, S = 2, 12
# the JAX side compiled (cfg is static), as it runs in use
jax_forward = jax.jit(jax_tfm.forward_zamba, static_argnums=1)
jax_prefill = jax.jit(jax_tfm.prefill_zamba, static_argnums=(1, 3))
jax_decode = jax.jit(jax_tfm.decode_zamba, static_argnums=1)


def _cfgs(**kw):
    kw = {"compute_dtype": "float32", "attention_impl": "flash", **kw}
    return (jax_configs.get(ARCH, smoke=True).replace(**kw),
            configs.get(ARCH, smoke=True).replace(**kw))


@functools.lru_cache(maxsize=None)
def _tree() -> dict:
    """The SMOKE params as numpy, redrawn from seed 11 (compute dtype and route
    do not change them)."""
    _, tcfg = _cfgs()
    params = Model(tcfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    redraw_params_(params, seed=11)
    return bridge.params_to_jax(params, tcfg)


def _params(jcfg, tcfg):
    tree = _tree()
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_jax(tree, tcfg, device="cpu"))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), _np(j), **tol)


def _rel(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# evaluation path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_forward_zamba_matches_jax(impl):
    jcfg, tcfg = _cfgs(attention_impl=impl)
    jparams, tparams = _params(jcfg, tcfg)
    tokens = _tokens(tcfg, (B, S))
    jlogits, _ = jax_forward(jparams, jcfg, jnp.asarray(tokens))
    tlogits, aux = tfm.forward_zamba(tparams, tcfg, torch.from_numpy(tokens).long())
    assert tlogits.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    _close(tlogits, jlogits)


def test_loss_and_eval_step_match_jax():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(jcfg, tcfg)
    tokens = _tokens(tcfg, (B, S + 1))
    mask = (np.random.default_rng(2).random((B, S)) > 0.3).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(tokens[:, :-1]), "labels": jnp.asarray(tokens[:, 1:])}
    tbatch = {"tokens": torch.from_numpy(tokens[:, :-1]).long(),
              "labels": torch.from_numpy(tokens[:, 1:]).long()}
    jloss = jax.jit(jax_make_eval_step(JaxModel(jcfg)))(jparams, jbatch)["loss"]
    tloss = make_eval_step(Model(tcfg))(tparams, tbatch)["loss"]
    assert tloss.dtype == torch.float32 and tloss.shape == ()
    _close(tloss, jloss)
    jbatch["loss_mask"], tbatch["loss_mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    _close(Model(tcfg).loss(tparams, tbatch), JaxModel(jcfg).loss(jparams, jbatch))


def test_forward_calls_the_scan_kernel_once_per_mamba_layer(monkeypatch):
    """Forward sends each Mamba2 layer's scan to the kernel entry point under
    "flash" (and never under "xla"); prefill and decode never call it.  On CPU
    tensors the entry point counts no launch."""
    calls = []
    real = ssm.kernel_ops.mamba_scan

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    monkeypatch.setattr(ssm.kernel_ops, "mamba_scan", spy)
    _, tcfg = _cfgs()
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0), device="cpu")
    tokens = torch.ones((1, 5), dtype=torch.long)
    before = ms_kernel.mamba_scan.launches
    _, H, P, _, _ = ssm.dims(tcfg)
    model.forward(params, {"tokens": tokens})
    assert calls == [(1, 5, H, P)] * tcfg.n_layers
    Model(tcfg.replace(attention_impl="xla")).forward(params, {"tokens": tokens})
    _, cache = model.prefill(params, {"tokens": tokens}, 8)
    model.decode_step(params, tokens[:, :1], cache, 5)
    assert len(calls) == tcfg.n_layers
    assert ms_kernel.mamba_scan.launches == before


# ---------------------------------------------------------------------------
# serving path
# ---------------------------------------------------------------------------


def _flat(caches) -> dict:
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(caches)}


def _check_caches(tcache, jcache):
    tflat, jflat = _flat(tcache), _flat(jcache)
    assert sorted(tflat) == sorted(jflat)
    assert len(tflat) == 6  # groups/{conv,h}, shared/{k,v}, tail/{conv,h}
    for key, jleaf in jflat.items():
        assert tuple(tflat[key].shape) == jleaf.shape, key
        assert str(tflat[key].dtype) == f"torch.{jleaf.dtype}", key
        _close(tflat[key], jleaf)


def test_prefill_zamba_matches_jax():
    """Last logits and every cache leaf: SSM states, conv windows and the
    shared block's KV caches, one per application."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(jcfg, tcfg)
    tokens, max_len = _tokens(tcfg, (B, S)), S + 6
    jlogits, jcache = jax_prefill(jparams, jcfg, jnp.asarray(tokens), max_len)
    tlogits, tcache = tfm.prefill_zamba(tparams, tcfg, torch.from_numpy(tokens).long(), max_len)
    assert tlogits.shape == (B, 1, tcfg.vocab_size)
    n_groups, period, tail = tfm.zamba_structure(tcfg)
    assert tcache["shared"]["k"].shape[0] == n_groups
    assert tcache["groups"]["h"].shape[:2] == (n_groups, period)
    _close(tlogits, jlogits)
    _check_caches(tcache, jcache)


def test_decode_zamba_matches_jax_for_8_steps():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(jcfg, tcfg)
    tokens = _tokens(tcfg, (B, 5 + 8))
    max_len = tokens.shape[1]
    _, jcache = jax_prefill(jparams, jcfg, jnp.asarray(tokens[:, :5]), max_len)
    _, tcache = tfm.prefill_zamba(tparams, tcfg, torch.from_numpy(tokens[:, :5]).long(),
                                  max_len)
    for pos in range(5, 13):
        new = tokens[:, pos:pos + 1]
        jlogits, jcache = jax_decode(jparams, jcfg, jnp.asarray(new), jcache,
                                     jnp.asarray(pos, jnp.int32))
        tlogits, tcache = tfm.decode_zamba(tparams, tcfg, torch.from_numpy(new).long(),
                                           tcache, pos)
        _close(tlogits, jlogits)
    _check_caches(tcache, jcache)


def test_init_cache_matches_jax():
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    jcache = JaxModel(jcfg).init_cache(3, 10)
    tcache = Model(tcfg).init_cache(3, 10, device="cpu")
    jflat, tflat = _flat(jcache), _flat(tcache)
    assert sorted(jflat) == sorted(tflat)
    for key, jleaf in jflat.items():
        assert tuple(tflat[key].shape) == jleaf.shape, key
        assert str(tflat[key].dtype) == f"torch.{jleaf.dtype}", key
        assert not tflat[key].any()


def _serve(engine_cls, accum_cls, model, params, prompts, eos, **kw):
    engine = engine_cls(model, params, max_len=24, eos_token=eos, **kw)
    accum = accum_cls(engine, max_batch=3)
    for p in prompts:
        accum.submit(p)
    return accum.flush(max_new_tokens=8), engine.stats


def test_serve_engine_tokens_identical_to_jax():
    """Greedy serving of ragged, left-padded prompts, with and without EOS."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab_size, n) for n in (5, 9, 3, 12, 7)]
    jax_side = (JaxEngine, JaxAccumulator, JaxModel(jcfg), jparams, prompts)
    port_side = (ServeEngine, BatchAccumulator, Model(tcfg), tparams, prompts)

    ref, _ = _serve(*port_side, None, device="cpu")
    eos = int(ref[0]["tokens"][2])  # ends request 0 after 3 tokens
    for eos_token in (None, eos):
        jout, jstats = _serve(*jax_side, eos_token)
        tout, tstats = _serve(*port_side, eos_token, device="cpu")
        assert tstats == jstats
        assert len(tout) == len(jout) == len(prompts)
        for t, j in zip(tout, jout):
            assert t["prompt_len"] == j["prompt_len"]
            np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert (tout[0]["tokens"][3:] == eos).all() and len(tout[0]["tokens"]) == 8


# ---------------------------------------------------------------------------
# params, bridge and bf16
# ---------------------------------------------------------------------------


def test_bridge_round_trips_zamba_bitwise():
    """zamba2's nested tree (groups [n_groups, period, ...], tail, shared,
    lora) crosses leaf for leaf in jax.tree_util's order."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(jcfg, tcfg)
    n_groups, period, tail = tfm.zamba_structure(tcfg)
    assert tparams["groups"]["mamba"]["A_log"].shape[:2] == (n_groups, period)
    assert tparams["tail"]["norm"]["scale"].shape[0] == tail
    assert tparams["lora"]["qkv_a"].shape[0] == n_groups
    back = bridge.params_to_jax(tparams, tcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    bleaves = jax.tree_util.tree_leaves_with_path(back)
    assert len(jleaves) == len(bleaves) == 34
    for (jp, j), (bp, b) in zip(jleaves, bleaves):
        assert jp == bp and b.dtype == j.dtype
        np.testing.assert_array_equal(b, np.asarray(j))


def test_bf16_forward_matches_jax():
    """Port vs JAX in bf16 over the whole SMOKE forward, on the relative L2 of
    every position's logits.

    bf16 rounding alone moves these logits some 6e-2 from f32, and two
    correct bf16 implementations differ by about as much: JAX's own jitted and
    op-by-op (``unroll_layers=True``, unjitted) runs sit 4.2e-2 apart, since
    XLA fuses elementwise chains and rounds at other places.  So the port is
    held against jitted JAX within twice JAX's own spread, and its
    bf16-vs-f32 drift within 10 % of JAX's, as tests/test_torch_bf16.py does.
    Both take the "xla" route, which rounds the scan's f32 result to bf16 once
    as the kernel does."""
    d = distances(attention_impl="xla")
    assert d["port_bf16_vs_jax_bf16"] <= 2 * d["jax_jit_vs_op_by_op"], d
    assert d["port_f32_vs_jax_f32"] <= 1e-5, d
    assert abs(d["port_drift"] / d["jax_drift"] - 1) <= 0.1, d


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_bf16_mamba_layer_matches_jax(impl):
    """One Mamba2 layer in bf16 (its f32 islands: softplus, A, the scan, the
    gated norm), port vs jitted JAX, where rounding has not yet compounded."""
    jcfg, tcfg = _cfgs(attention_impl=impl, compute_dtype="bfloat16")
    jparams, tparams = _params(jcfg, tcfg)
    x = np.random.default_rng(5).standard_normal((4, 20, tcfg.d_model)).astype(np.float32)
    jlayer = jax.tree_util.tree_map(lambda a: a[0, 0], jparams["groups"])["mamba"]
    tlayer = tfm.layer_params(tfm.layer_params(tparams["groups"], 0), 0)["mamba"]
    jout = jax.jit(lambda p, x: jax_ssm.apply_mamba(p, jcfg, x)[0])(
        jlayer, jnp.asarray(x, jnp.bfloat16))
    with torch.inference_mode():
        tout, _ = ssm.apply_mamba(tlayer, tcfg, torch.from_numpy(x).bfloat16())
    assert tout.dtype == torch.bfloat16
    assert _rel(tout, jout) <= BF16_TOL


def distances(**kw) -> dict:
    """Relative L2 distances of SMOKE forward logits (B 8, S 32) between the
    two packages and the two dtypes; JAX jitted, and in bf16 also op by op."""
    jcfg, tcfg = _cfgs(**kw)
    jparams, tparams = _params(jcfg, tcfg)
    tokens = _tokens(tcfg, (8, 32))
    jtok = jnp.asarray(tokens)
    bf16 = jcfg.replace(compute_dtype="bfloat16")
    out = {("jax", "float32"): jax_forward(jparams, jcfg, jtok)[0],
           ("jax", "bfloat16"): jax_forward(jparams, bf16, jtok)[0],
           "jax_op_by_op": jax_tfm.forward_zamba(
               jparams, bf16.replace(unroll_layers=True), jtok)[0]}
    for dtype in ("float32", "bfloat16"):
        with torch.inference_mode():
            out["port", dtype] = tfm.forward_zamba(tparams, tcfg.replace(compute_dtype=dtype),
                                                   torch.from_numpy(tokens).long())[0]
    assert out["port", "bfloat16"].dtype == torch.bfloat16
    return {
        "jax_drift": _rel(out["jax", "bfloat16"], out["jax", "float32"]),
        "port_drift": _rel(out["port", "bfloat16"], out["port", "float32"]),
        "jax_jit_vs_op_by_op": _rel(out["jax", "bfloat16"], out["jax_op_by_op"]),
        "port_bf16_vs_jax_bf16": _rel(out["port", "bfloat16"], out["jax", "bfloat16"]),
        "port_f32_vs_jax_f32": _rel(out["port", "float32"], out["jax", "float32"]),
    }


def superblock_distances(d_model: int) -> dict:
    """The port alone, flash (the scan's plain version here) against xla, in
    bf16 and f32, over the first super-block (6 Mamba2 layers and one shared
    application) of zamba2-7b with the width cut to ``d_model``; B 8, S 256.
    The witness for chip_smoke.py's bf16 limit on the same comparison."""
    full = configs.get(ARCH)
    cfg = full.replace(n_layers=full.zamba.shared_period, d_model=d_model,
                       n_heads=d_model // 112, n_kv_heads=d_model // 112,
                       d_ff=4 * d_model, attention_impl="flash")
    params = Model(cfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    redraw_params_(params, seed=11)
    tokens = torch.from_numpy(_tokens(cfg, (8, 256)).astype(np.int64))
    logits = {}
    with torch.inference_mode():
        for dtype in ("float32", "bfloat16"):
            for impl in ("flash", "xla"):
                c = cfg.replace(compute_dtype=dtype, attention_impl=impl)
                logits[impl, dtype] = tfm.forward_zamba(params, c, tokens)[0]
    return {
        "flash_vs_xla_bf16": _rel(logits["flash", "bfloat16"], logits["xla", "bfloat16"]),
        "flash_vs_xla_f32": _rel(logits["flash", "float32"], logits["xla", "float32"]),
        "xla_bf16_vs_f32": _rel(logits["xla", "bfloat16"], logits["xla", "float32"]),
    }


def main() -> None:
    for impl in ("flash", "xla"):
        jcfg, tcfg = _cfgs(attention_impl=impl)
        jparams, tparams = _params(jcfg, tcfg)
        tokens = _tokens(tcfg, (B, S))
        jlogits = jax_forward(jparams, jcfg, jnp.asarray(tokens))[0]
        tlogits = tfm.forward_zamba(tparams, tcfg, torch.from_numpy(tokens).long())[0]
        print(f"SMOKE forward f32, {impl}, port vs JAX max |diff|:",
              float(np.abs(_np(tlogits) - _np(jlogits)).max()))
    print("SMOKE forward, xla route (relative L2 of the logits):",
          distances(attention_impl="xla"))
    for d_model in (448, 896):
        print(f"first super-block, d {d_model}, port flash vs xla:",
              superblock_distances(d_model))


if __name__ == "__main__":
    main()
