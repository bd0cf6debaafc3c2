"""Public entry points of the kernels.

A CUDA tensor always launches the hand-written kernel; a CPU tensor always
takes the kernel's plain version in :mod:`repro_torch.kernels.ref`.  The
reference's block- and chunk-halving loops (``repro/kernels/ops.py:28-31,
43-44``) are a TPU tiling workaround and have no counterpart: the CUDA kernels
mask ragged edges themselves.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    logit_softcap: float | None = None) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 logit_softcap=logit_softcap)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               logit_softcap=logit_softcap)


def mamba_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked SSD scan forward: y [B,S,H,P] in xh's dtype, no final state.
    The result does not depend on ``chunk`` beyond rounding."""
    if xh.device.type == "cpu":
        y, _ = ref.mamba_scan_ref(xh, dt, A, Bm, Cm)
        return y
    return _ms.mamba_scan(xh, dt, A, Bm, Cm, chunk=chunk)
