"""Wrapper of the hand-written Hopper flash-attention kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel in
``repro/kernels/flash_attention.py``; it is bound through a plain C interface
loaded with ctypes (see :mod:`repro_torch.kernels.build`).  This wrapper only
launches it: it checks what it is given and raises on anything the kernel does
not take, and never falls back to another implementation.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# every multiple of 16 from 16 to 128: csrc/flash_attention.cu instantiates each
HEAD_DIMS = tuple(range(16, 129, 16))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        # q, k, v, o; B, S, T, H, K, D, causal, window; softcap; dtype; stream.
        # Pointers and the stream as c_void_p: a plain int would be cut to 32 bits.
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, logit_softcap: float | None) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; takes float32 and bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,S,H,D], k = v [B,T,K,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not a multiple of 16 from 16 to 128; "
                         f"the kernel takes {HEAD_DIMS}")
    if H % k.shape[2]:
        raise ValueError(f"{H} q heads do not group over {k.shape[2]} kv heads")
    if 0 in (B, S, k.shape[1]):
        raise ValueError("empty batch or sequence")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if logit_softcap is not None and logit_softcap < 0:
        raise ValueError(f"logit_softcap must be positive, got {logit_softcap}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    logit_softcap: float | None = None) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,T,K,D] on one CUDA device -> [B,S,H,D] in q's dtype."""
    _check(q, k, v, window, logit_softcap)
    lib = _bind()
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, K, D, int(causal), window or 0, float(logit_softcap or 0.0),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    if not causal:
        flash_attention.noncausal_launches += 1
    return out


flash_attention.launches = 0  # kernel launches since the last reset
flash_attention.noncausal_launches = 0  # of which with causal=False
