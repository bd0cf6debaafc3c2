"""Wrapper of the hand-written Hopper chunked SSD scan kernel.

The kernel (``csrc/mamba_scan.cu``) replaces the Pallas TPU kernel in
``repro/kernels/mamba_scan.py``; it is bound through a plain C interface
loaded with ctypes (see :mod:`repro_torch.kernels.build`).  This wrapper only
launches it: it checks what it is given and raises on anything the kernel does
not take, and never falls back to another implementation.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_DIM = 128          # largest head dim P, state dim N and chunk
TILE_ROWS = 16         # rows of the chunk's weight the FMA kernel builds at a time
PAD = 8                # bf16 elements of padding a staged row on the tensor-core route
SMEM_LIMIT = 232_448   # bytes of shared memory a block may use on Hopper
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"fma": 0, "tensor_core": 1}  # the kernel's routes and their codes


def route(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> str:
    """The kernel's route, from dtypes, shapes, strides and alignment alone:
    bf16 with P, N and chunk multiples of 16, xh, Bm and Cm rows that
    cp.async can copy 16 bytes at a time (16-byte aligned bases, batch, seq
    and head strides multiples of 8 elements), and tiles that fit in shared
    memory, takes the tensor cores; the rest, and all f32, the FMA kernel."""
    S, P, N = xh.shape[1], xh.shape[-1], Bm.shape[-1]
    strides = (*xh.stride()[:3], *Bm.stride()[:2], *Cm.stride()[:2])
    if (xh.dtype == torch.bfloat16 and P % 16 == 0 and N % 16 == 0 and chunk % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (xh, Bm, Cm))
            and all(s % 8 == 0 for s in strides)
            and smem_bytes(kernel_chunk(chunk, S, "tensor_core"), P, N, "tensor_core")
            <= SMEM_LIMIT):
        return "tensor_core"
    return "fma"


def kernel_chunk(chunk: int, S: int, path: str) -> int:
    """The chunk the kernel runs: at most S rounded up to the route's 16-row
    tiles (FMA: to S).  Rows past S are zero-filled, and the result does not
    depend on the chunk beyond rounding."""
    return min(chunk, -(-S // 16) * 16 if path == "tensor_core" else S)


def smem_bytes(chunk: int, P: int, N: int, path: str) -> int:
    """Shared memory of one block on route ``path``.  FMA: x, B, C (rows padded
    to N+1), h, one row tile of the weight, dt and decay-to-end, all f32, and
    cum in f64.  Tensor cores: two stages of x, B, C (bf16, rows padded by
    PAD) and dt, h [P, N+PAD] in f32 and as bf16 hi + lo, cum in f64 and as
    f32 hi + lo, and the state weights."""
    if path == "tensor_core":
        stage = 2 * chunk * (P + PAD) + 4 * chunk * (N + PAD) + 4 * chunk
        return 2 * stage + 8 * P * (N + PAD) + 20 * chunk
    return 4 * (chunk * P + 2 * chunk * (N + 1) + P * (N + 1) + TILE_ROWS * chunk + 4 * chunk)


def _bind() -> ctypes.CDLL:
    lib = build.load("mamba_scan")
    fn = lib.mamba_scan_fwd
    if fn.argtypes is None:
        # x, dt, A, Bm, Cm, y; B, S, H, P, N, chunk; ten strides; dtype; route;
        # stream.  Pointers and the stream as c_void_p: a plain int would be
        # cut to 32 bits.
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 10 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(xh, dt, A, Bm, Cm, chunk: int) -> str:
    """Raises on anything the kernel does not take; returns its route."""
    if xh.device.type != "cuda":
        raise ValueError(f"mamba_scan kernel needs CUDA tensors, got {xh.device}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, xh on {xh.device}")
    if xh.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {xh.dtype}; takes float32 and bfloat16")
    if Bm.dtype != xh.dtype or Cm.dtype != xh.dtype:
        raise ValueError(f"Bm {Bm.dtype} and Cm {Cm.dtype} must be xh's {xh.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt {dt.dtype} and A {A.dtype} must be float32")
    if xh.dim() != 4:
        raise ValueError(f"want xh [B,S,H,P], got {tuple(xh.shape)}")
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (B, S, N) or tuple(Cm.shape) != (B, S, N)):
        raise ValueError(f"want dt [B,S,H], A [H], Bm = Cm [B,S,N] for xh {tuple(xh.shape)}; "
                         f"got {tuple(dt.shape)}, {tuple(A.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    if 0 in (B, S, H):
        raise ValueError("empty batch, sequence or heads")
    if not (1 <= P <= MAX_DIM and 1 <= N <= MAX_DIM and 1 <= chunk <= MAX_DIM):
        raise ValueError(f"P {P}, N {N} and chunk {chunk} must lie in [1, {MAX_DIM}]")
    path = route(xh, Bm, Cm, chunk)
    need = smem_bytes(kernel_chunk(chunk, S, path), P, N, path)
    if need > SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} at P {P}, N {N} needs {need} bytes of shared memory "
                         f"on the {path} route, more than {SMEM_LIMIT}; use a smaller chunk")
    if xh.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("xh, Bm and Cm need unit stride in their last dimension")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    return path


def mamba_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """xh [B,S,H,P], dt [B,S,H] f32, A [H] f32, Bm/Cm [B,S,N] on one CUDA device
    -> y [B,S,H,P] in xh's dtype (contiguous).  xh, Bm and Cm may be strided
    views (unit stride in the last dimension); the route follows from the
    inputs (:func:`route`)."""
    path = _check(xh, dt, A, Bm, Cm, chunk)
    lib = _bind()
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    y = torch.empty(xh.shape, dtype=xh.dtype, device=xh.device)
    err = lib.mamba_scan_fwd(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), B, S, H, P, N, kernel_chunk(chunk, S, path),
        xh.stride(0), xh.stride(1), xh.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
        _DTYPE_CODES[xh.dtype], ROUTES[path], torch.cuda.current_stream(xh.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {err}")
    mamba_scan.launches += 1
    return y


mamba_scan.launches = 0  # kernel launches since the last reset
