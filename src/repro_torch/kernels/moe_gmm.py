"""Wrapper of the hand-written Hopper grouped-matmul kernel.

The kernel (``csrc/moe_gmm.cu``) replaces the Pallas TPU kernel in
``repro/kernels/moe_gmm.py``; it is bound through a plain C interface loaded
with ctypes (see :mod:`repro_torch.kernels.build`).  This wrapper only
launches it: it checks what it is given and raises on anything the kernel does
not take, and never falls back to another implementation.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

BLOCK = 64            # rows of C of one block's output tile (FMA and wmma routes)
MAX_GRID_YZ = 65535   # CUDA's limit on the grid's y (C tiles) and z (E) sizes
# the kernel's routes and their codes in gmm_fwd
ROUTES = {"fma_f32": 0, "wmma": 1, "tma_wgmma": 2}


def _bind() -> ctypes.CDLL:
    lib = build.load("moe_gmm")
    fn = lib.gmm_fwd
    if fn.argtypes is None:
        # x, w, out; E, C, D, F, Ew; route; stream.
        # Pointers and the stream as c_void_p: a plain int would be cut to 32 bits.
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel's route for x [E,C,D] and w [Ew,D,F], from their dtype,
    shapes and alignment alone: f32 takes the exact FMA kernel; bf16 takes
    TMA + wgmma where TMA can read both tensors (rows of D and F a multiple
    of 16 bytes, 16-byte aligned bases), else the wmma kernel."""
    if x.dtype == torch.float32:
        return "fma_f32"
    D, F = x.shape[2], w.shape[2]
    if D % 8 == 0 and F % 8 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0:
        return "tma_wgmma"
    return "wmma"


def _check(x: torch.Tensor, w: torch.Tensor) -> str:
    """Raises on anything the kernel does not take; returns its route."""
    if x.device.type != "cuda":
        raise ValueError(f"gmm kernel needs CUDA tensors, got {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {x.dtype}; takes float32 and bfloat16")
    if w.dtype != x.dtype:
        raise ValueError(f"w is {w.dtype}, x is {x.dtype}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"want x [E,C,D], w [Ew,D,F]; got {tuple(x.shape)}, {tuple(w.shape)}")
    if 0 in x.shape or 0 in w.shape:
        raise ValueError(f"empty x {tuple(x.shape)} or w {tuple(w.shape)}")
    E, C, _ = x.shape
    path = route(x, w)
    if path != "tma_wgmma" and (E > MAX_GRID_YZ or -(-C // BLOCK) > MAX_GRID_YZ):
        raise ValueError(f"E {E} or C {C} exceeds the kernel's grid")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    return path


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E,C,D], w [Ew,D,F] on one CUDA device -> [E,C,F] in x's dtype, group
    ``e`` against slab ``e % Ew``, summed in f32.  Any C, D, F; the route
    follows from the inputs (:func:`route`)."""
    path = _check(x, w)
    lib = _bind()
    E, C, D = x.shape
    Ew, _, F = w.shape
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    err = lib.gmm_fwd(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F, Ew,
        ROUTES[path], torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gmm kernel launch failed: CUDA error {err}")
    gmm.launches += 1
    return out


gmm.launches = 0  # kernel launches since the last reset
