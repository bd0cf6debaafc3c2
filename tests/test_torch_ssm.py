"""The port's SSD scan and Mamba2 block against the JAX package's, on the CPU.

The scan's entry point (``repro_torch.kernels.ops.mamba_scan``, which takes
the plain version ``mamba_scan_ref`` for CPU tensors) is held against the
Pallas kernel in interpret mode and the JAX oracle over the grid of
``tests/kernels/test_kernels.py:98-103`` in f32 and bf16, at the reference's
tolerances (2e-5 / 2e-2).  The CUDA kernel itself runs only on the card;
``chip_smoke.py`` holds it against the plain version there.  Inputs are
seeded numpy arrays handed to both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.mamba_scan import mamba_scan as jax_mamba_scan
from repro.models import ssm as jax_ssm
from repro_torch import configs
from repro_torch.kernels import mamba_scan as ms_kernel
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# the JAX side compiled (f32 throughout, so compiling changes no rounding)
jax_ssd_chunked = jax.jit(jax_ssm.ssd_chunked, static_argnames=("chunk", "return_final_state"))
jax_apply_mamba = jax.jit(jax_ssm.apply_mamba, static_argnums=1,
                          static_argnames="return_cache")

# B, S, H, P, N, chunk (tests/kernels/test_kernels.py:98-103)
CASES = [
    (2, 64, 2, 8, 16, 16),
    (1, 128, 4, 16, 8, 32),
    (2, 96, 1, 8, 8, 32),
    (1, 64, 2, 64, 64, 64),   # realistic head/state dims
]


def _inputs(B, S, H, P, N, seed=0):
    """xh, dt (softplus'd, f32), A (negative, one value per head), Bm, Cm."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


def _as(arrays, dtype, lib):
    """Cast xh, Bm, Cm to ``dtype`` (dt and A stay f32), as torch or jnp arrays."""
    xh, dt, A, Bm, Cm = arrays
    if lib == "torch":
        cast = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
        return cast(xh), torch.from_numpy(dt), torch.from_numpy(A), cast(Bm), cast(Cm)
    cast = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
    return cast(xh), jnp.asarray(dt), jnp.asarray(A), cast(Bm), cast(Cm)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_scan(case, dtype):
    B, S, H, P, N, chunk = case
    xh, dt, A, Bm, Cm = _as(_inputs(B, S, H, P, N), dtype, "jax")
    y_ref, h_ref = jax_ref.mamba_scan_ref(xh, dt, A, Bm, Cm)
    return {
        "ref": _np(y_ref),
        "h": _np(h_ref),
        "pallas": _np(jax_mamba_scan(xh, dt, A, Bm, Cm, chunk=chunk, interpret=True)),
    }


@pytest.mark.parametrize("jax_side", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_mamba_scan_matches_jax(case, dtype, jax_side):
    B, S, H, P, N, chunk = case
    args = _as(_inputs(B, S, H, P, N), dtype, "torch")
    out = ops.mamba_scan(*args, chunk=chunk)
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    np.testing.assert_allclose(_np(out), _jax_scan(case, dtype)[jax_side], **TOL[dtype])


def test_mamba_scan_ref_final_state_matches_jax():
    case = CASES[1]
    y, h = ref.mamba_scan_ref(*_as(_inputs(*case[:5]), "float32", "torch"))
    assert h.dtype == torch.float32
    np.testing.assert_allclose(_np(h), _jax_scan(case, "float32")["h"], **TOL["float32"])


@pytest.mark.parametrize("S", [37, 100])
def test_mamba_scan_ragged_length_matches_jax_ops(S):
    """JAX's wrapper halves the chunk until it divides S (chunk 1 at S = 37);
    the port's entry point takes the chunk as it is.  The result does not
    depend on the chunk beyond rounding."""
    arrays = _inputs(2, S, 3, 8, 16, seed=S)
    expected = _np(jax_ops.mamba_scan(*_as(arrays, "float32", "jax"), chunk=32))
    out = ops.mamba_scan(*_as(arrays, "float32", "torch"), chunk=32)
    np.testing.assert_allclose(_np(out), expected, **TOL["float32"])


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches or raises; it never computes on the CPU."""
    args = _as(_inputs(*CASES[0][:5]), "float32", "torch")
    before = ms_kernel.mamba_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        ms_kernel.mamba_scan(*args, chunk=16)
    assert ms_kernel.mamba_scan.launches == before


def test_ops_routes_cpu_tensors_to_the_plain_version():
    args = _as(_inputs(*CASES[2][:5]), "float32", "torch")
    before = ms_kernel.mamba_scan.launches
    assert torch.equal(ops.mamba_scan(*args, chunk=32), ref.mamba_scan_ref(*args)[0])
    assert ms_kernel.mamba_scan.launches == before


def test_kernel_shared_memory_fits_at_the_model_shapes():
    """zamba2-7b (P = N = 64, chunk 128) fits one block on both routes, its
    SMOKE cut on the FMA route; P = N = 128 fits the FMA route at chunk 64
    but neither route at 128, which the wrapper refuses."""
    for P, N, chunk in ((64, 64, 128), (8, 8, 16), (128, 128, 64)):
        assert ms_kernel.smem_bytes(chunk, P, N, "fma") <= ms_kernel.SMEM_LIMIT
    assert ms_kernel.smem_bytes(128, 64, 64, "tensor_core") <= ms_kernel.SMEM_LIMIT
    for path in ("fma", "tensor_core"):
        assert ms_kernel.smem_bytes(128, 128, 128, path) > ms_kernel.SMEM_LIMIT


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [64, 45])
def test_ssd_chunked_matches_jax(S, with_h0):
    """ssd_chunked pads S to the chunk; with an initial state and the final
    state returned, as prefill uses it."""
    B, H, P, N, chunk = 2, 3, 8, 16, 16
    arrays = _inputs(B, S, H, P, N, seed=7)
    h0 = np.random.default_rng(8).standard_normal((B, H, P, N)).astype(np.float32)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    jy, jh = jax_ssd_chunked(*_as(arrays, "float32", "jax"), chunk=chunk, h0=jh0,
                             return_final_state=True)
    ty, th = ssm.ssd_chunked(*_as(arrays, "float32", "torch"), chunk=chunk, h0=th0,
                             return_final_state=True)
    assert ty.shape == (B, S, H, P) and th.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL["float32"])
    np.testing.assert_allclose(_np(th), _np(jh), **TOL["float32"])
    # and against the literal recurrence
    ry, rh = ref.mamba_scan_ref(*_as(arrays, "float32", "torch"), h0=th0)
    np.testing.assert_allclose(_np(ty), _np(ry), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(th), _np(rh), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# apply_mamba, all three routes
# ---------------------------------------------------------------------------


def _mamba_params(cfg, seed=3):
    """Random values for every leaf of one Mamba2 layer, the inert ones
    (A_log, dt_bias, conv_b, D: ones and zeros at init) included."""
    rng = np.random.default_rng(seed)
    d_inner, H, P, N, G = ssm.dims(cfg)
    conv_ch = d_inner + 2 * G * N
    d = cfg.d_model
    return {
        "in_proj": {"w": (rng.standard_normal((d, 2 * d_inner + 2 * N + H)) / np.sqrt(d))},
        "conv_w": rng.standard_normal((cfg.ssm.conv_width, conv_ch)) * 0.5,
        "conv_b": rng.standard_normal(conv_ch) * 0.1,
        "A_log": rng.uniform(-1.0, 1.0, H),
        "D": rng.uniform(0.5, 1.5, H),
        "dt_bias": rng.standard_normal(H) * 0.5,
        "norm_scale": rng.uniform(0.5, 1.5, d_inner),
        "out_proj": {"w": rng.standard_normal((d_inner, d)) / np.sqrt(d_inner)},
    }


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(np.asarray(tree, np.float32))


@pytest.mark.parametrize("route", ["flash", "xla", "prefill", "decode"])
def test_apply_mamba_matches_jax(route):
    kw = dict(compute_dtype="float32", attention_impl="xla" if route == "xla" else "flash")
    jcfg = jax_configs.get("zamba2-7b", smoke=True).replace(**kw)
    tcfg = configs.get("zamba2-7b", smoke=True).replace(**kw)
    params = _mamba_params(tcfg)
    jp, tp = _tree(params, jnp.asarray), _tree(params, torch.from_numpy)
    B, S = 2, 21
    x = np.random.default_rng(4).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    if route == "decode":
        d_inner, H, P, N, G = ssm.dims(tcfg)
        rng = np.random.default_rng(5)
        cache = {"h": rng.standard_normal((B, H, P, N)).astype(np.float32),
                 "conv": rng.standard_normal((B, tcfg.ssm.conv_width - 1,
                                              d_inner + 2 * N)).astype(np.float32)}
        x = x[:, :1]
        jout, jcache = jax_apply_mamba(jp, jcfg, jnp.asarray(x), cache=_tree(cache, jnp.asarray))
        tout, tcache = ssm.apply_mamba(tp, tcfg, torch.from_numpy(x),
                                       cache=_tree(cache, torch.from_numpy))
    else:
        prefill = route == "prefill"
        jout, jcache = jax_apply_mamba(jp, jcfg, jnp.asarray(x), return_cache=prefill)
        tout, tcache = ssm.apply_mamba(tp, tcfg, torch.from_numpy(x), return_cache=prefill)
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-4, atol=1e-4)
    assert (tcache is None) == (jcache is None)
    if tcache is not None:
        assert sorted(tcache) == sorted(jcache) == ["conv", "h"]
        for key in tcache:
            assert tcache[key].shape == jcache[key].shape
            np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), rtol=1e-4, atol=1e-4)


def test_init_mamba_cache_dtypes():
    cfg = configs.get("zamba2-7b", smoke=True)
    jcache = jax_ssm.init_mamba_cache(jax_configs.get("zamba2-7b", smoke=True), 3, jnp.bfloat16)
    tcache = ssm.init_mamba_cache(cfg, 3, torch.bfloat16, "cpu")
    for key in ("h", "conv"):
        assert tcache[key].shape == jcache[key].shape
        assert str(tcache[key].dtype) == f"torch.{jcache[key].dtype}"
        assert not tcache[key].any()
