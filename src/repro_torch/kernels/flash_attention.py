"""Wrappers of the hand-written Hopper flash-attention kernels.

The serving kernel (``csrc/flash_attention.cu``, :func:`flash_attention`)
replaces the Pallas TPU kernel in ``repro/kernels/flash_attention.py``.  The
training pair (:func:`flash_attention_fwd_lse`, :func:`flash_attention_bwd`)
is causal self-attention and its gradient for the ``xla`` route's training
step, which the reference leaves to XLA's fusion, at the (q.k, v) head dims
of :data:`CAUSAL_HEAD_DIMS` (latent attention's q.k 192 and v 128 among
them).  All are bound through a
plain C interface loaded with ctypes (see :mod:`repro_torch.kernels.build`).
These wrappers only launch them: they check what they are given and raise on
anything the kernels do not take, and never fall back to another
implementation.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# every multiple of 16 from 16 to 128: csrc/flash_attention.cu instantiates each
HEAD_DIMS = tuple(range(16, 129, 16))
# the training pair's (q.k, v) head dims (bf16, causal, S = T): one width, or
# latent attention's 192-wide q.k (128 nope + 64 rope) with a 128-wide v
CAUSAL_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        # Pointers and the stream as c_void_p: a plain int would be cut to 32 bits.
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # q, k, v, o; B, S, T, H, K, D, causal, window; softcap; dtype; stream
        lib.flash_attention_fwd.argtypes = [ptr] * 4 + [i32] * 8 + [ctypes.c_float, i32, ptr]
        # q, k, v, o, lse; B, S, H, K, D, DV; stream
        lib.flash_attention_fwd_lse.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        # q, k, v, o, dout, lse, delta, dq, dk, dv; B, S, H, K, D, DV; stream
        lib.flash_attention_bwd.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
        for fn in (lib.flash_attention_fwd, lib.flash_attention_fwd_lse,
                   lib.flash_attention_bwd):
            fn.restype = ctypes.c_int
    return lib


def _check_tensors(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What every kernel of the file needs: q [B,S,H,D], k [B,T,K,D] and v
    [B,T,K,DV] contiguous tensors of one dtype on one device, H a multiple of
    K, nothing empty (the callers then check the widths, and the device
    last)."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; takes float32 and bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"want q [B,S,H,D], k [B,T,K,D], v [B,T,K,DV]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} q heads do not group over {k.shape[2]} kv heads")
    if 0 in (q.shape[0], q.shape[1], k.shape[1]):
        raise ValueError("empty batch or sequence")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def _check_cuda(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, logit_softcap: float | None) -> None:
    _check_tensors(q, k, v)
    D = q.shape[3]
    if v.shape[3] != D:
        raise ValueError(f"v {tuple(v.shape)} does not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not a multiple of 16 from 16 to 128; "
                         f"the kernel takes {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if logit_softcap is not None and logit_softcap < 0:
        raise ValueError(f"logit_softcap must be positive, got {logit_softcap}")
    _check_cuda(q)


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


def _check_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _check_tensors(q, k, v)
    dims = (q.shape[-1], v.shape[-1])
    if q.dtype != torch.bfloat16 or dims not in CAUSAL_HEAD_DIMS:
        raise ValueError(f"the training kernels take bf16 with (q.k, v) head dims in "
                         f"{CAUSAL_HEAD_DIMS}; got {q.dtype}, {dims}")
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"the training kernels take self-attention (S = T); got S "
                         f"{q.shape[1]}, T {k.shape[1]}")
    _check_cuda(q)


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal self-attention, positions from 0: q [B,S,H,D], k [B,S,K,D], v
    [B,S,K,DV] bf16 on one CUDA device -> (out [B,S,H,DV] bf16, lse [B,H,S]
    f32, each row's log-sum-exp of its scaled scores)."""
    _check_train(q, k, v)
    B, S, H, D = q.shape
    DV = v.shape[-1]
    out = q.new_empty((B, S, H, DV))
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _bind().flash_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, S, H, k.shape[2], D, DV, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd_lse kernel launch failed: CUDA error {err}")
    flash_attention_fwd_lse.launches += 1
    return out, lse


def flash_attention_bwd(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor,
                        lse: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`flash_attention_fwd_lse` at (q, k, v), from
    dout, its output ``out`` and ``lse``: (dq, dk, dv) in bf16."""
    _check_train(q, k, v)
    B, S, H, D = q.shape
    DV = v.shape[-1]
    for name, t, shape, dtype in (("dout", dout, (B, S, H, DV), q.dtype),
                                  ("out", out, (B, S, H, DV), q.dtype),
                                  ("lse", lse, (B, H, S), torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{name}: want {tuple(shape)} {dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _bind().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, S, H, k.shape[2], D, DV, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd_lse.launches = 0  # launches since the last reset
flash_attention_bwd.launches = 0  # backward passes (three kernel launches each)
