"""The port's attention kernel entry points against the JAX package's.

The port's plain version (``repro_torch.kernels.ref.attention_ref``) and its
CPU route of ``repro_torch.kernels.ops.flash_attention`` are held against the
JAX oracle ``repro.kernels.ref.attention_ref`` and the Pallas kernel run in
interpret mode, over the grid of ``tests/kernels/test_kernels.py`` plus
ragged lengths, a grouped, softcapped D 128 case and the head dims 96 and 112
with a window and a softcap.  The CUDA kernel itself runs only on the card;
``chip_smoke.py`` holds it against the plain version there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

# the port's tests need torch beside jax; without it they are not collected
torch = pytest.importorskip("torch")

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops, ref

# the reference's own tolerances (tests/kernels/test_kernels.py:20-21)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}

CASES = [
    (2, 128, 4, 2, 64, True, None, None),
    (1, 256, 4, 4, 64, True, None, None),     # MHA
    (2, 128, 4, 1, 32, True, None, None),     # MQA
    (2, 128, 4, 2, 64, False, None, None),    # bidirectional
    (1, 256, 2, 2, 32, True, 64, None),       # sliding window
    (1, 128, 2, 2, 64, True, None, 30.0),     # logit softcap
    (1, 64, 8, 2, 128, True, None, None),     # head_dim 128
    (2, 100, 4, 2, 16, True, None, None),     # ragged length, head_dim 16
    # what the bf16 tensor-core kernel's edge cases rest on: a length that is
    # not a multiple of 16 under a window, and 4 q heads a kv head at D 128
    # with softcap
    (1, 37, 4, 2, 64, True, 16, None),        # S 37, window 16
    (1, 128, 8, 2, 128, True, None, 30.0),    # G 4, head_dim 128, softcap
    # head dims whose rows are not whole 128-byte slabs of the bf16 kernel's
    # tiles: phi3-mini's 96 and zamba2's shared block's 112
    (1, 128, 4, 2, 96, True, None, None),     # head_dim 96
    (1, 256, 2, 2, 96, True, 64, None),       # head_dim 96, window
    (1, 128, 4, 2, 96, True, None, 30.0),     # head_dim 96, softcap
    (1, 128, 4, 2, 112, True, None, None),    # head_dim 112
    (1, 256, 2, 2, 112, True, 64, None),      # head_dim 112, window
    (1, 128, 4, 2, 112, True, None, 30.0),    # head_dim 112, softcap
]


def _inputs(case):
    B, S, H, K, D = case[:5]
    rng = np.random.default_rng(sum(case[:5]))
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D))]


@functools.lru_cache(maxsize=None)
def _jax_outputs(case, dtype):
    causal, window, softcap = case[5:]
    q, k, v = (jnp.asarray(x).astype(dtype) for x in _inputs(case))
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    return {
        "ref": np.asarray(jax_ref.attention_ref(q, k, v, **kw), np.float32),
        "pallas": np.asarray(jax_flash(q, k, v, interpret=True, **kw), np.float32),
    }


@pytest.mark.parametrize("jax_side", ["ref", "pallas"])
@pytest.mark.parametrize("port_fn", ["attention_ref", "ops.flash_attention"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_matches_jax(case, dtype, port_fn, jax_side):
    causal, window, softcap = case[5:]
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in _inputs(case))
    fn = ref.attention_ref if port_fn == "attention_ref" else ops.flash_attention
    out = fn(q, k, v, causal=causal, window=window, logit_softcap=softcap)
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), _jax_outputs(case, dtype)[jax_side],
                               **TOL[dtype])


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches or raises; it never computes on the CPU."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(CASES[0]))
    before = fa_kernel.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, k, v)
    assert fa_kernel.flash_attention.launches == before


@pytest.mark.parametrize("D", [8, 16, 32, 48, 64, 80, 96, 112, 128, 136, 512])
def test_kernel_wrapper_head_dims(D):
    """The kernel takes every multiple of 16 from 16 to 128 (on the CPU the
    wrapper then stops at the device) and refuses any other head dim."""
    q, k, v = (torch.zeros(1, 4, 2, D) for _ in range(3))
    takes = D % 16 == 0 and 16 <= D <= 128
    assert (D in fa_kernel.HEAD_DIMS) == takes
    with pytest.raises(ValueError, match="CUDA" if takes else "multiple of 16 from 16 to 128"):
        fa_kernel.flash_attention(q, k, v)


def test_ops_routes_cpu_tensors_to_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _inputs(CASES[2]))
    before = fa_kernel.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, ref.attention_ref(q, k, v, causal=True))
    assert fa_kernel.flash_attention.launches == before
