"""Public entry points of the kernels.

A CUDA tensor always launches the hand-written kernel; a CPU tensor always
takes the kernel's plain version in :mod:`repro_torch.kernels.ref`.  The
reference's block- and chunk-halving loops (``repro/kernels/ops.py:28-31,
43-44``) are a TPU tiling workaround and have no counterpart: the CUDA kernels
mask ragged edges themselves.  For the same reason ``gmm`` takes any C, D and
F, where the reference's raises unless they tile by its 128-wide blocks
(``repro/kernels/moe_gmm.py:59-60``).

None of the three has a backward kernel, and neither has the reference's: a
gradient through a Pallas call raises under ``jax.grad``.  So each entry point
raises ``NotImplementedError`` when autograd would record it (grad mode on and
an input that requires grad), on either route, rather than hand back an output
that silently carries no gradient.  Evaluation (``torch.inference_mode``) and
serving (parameters that do not require grad) are unaffected; training runs
the plain routes (``attention_impl="xla"``, ``ssd_chunked``, the einsum expert
FFN), as the reference's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref


def _no_backward(name: str, *inputs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            f"{name}: no backward kernel; the reference has none either.  Train "
            f"through the plain route (attention_impl='xla', ssd_chunked, the "
            f"einsum expert FFN)"
        )


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    logit_softcap: float | None = None) -> torch.Tensor:
    _no_backward("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 logit_softcap=logit_softcap)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               logit_softcap=logit_softcap)


def mamba_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked SSD scan forward: y [B,S,H,P] in xh's dtype, no final state.
    The result does not depend on ``chunk`` beyond rounding."""
    _no_backward("mamba_scan", xh, dt, A, Bm, Cm)
    if xh.device.type == "cpu":
        y, _ = ref.mamba_scan_ref(xh, dt, A, Bm, Cm)
        return y
    return _ms.mamba_scan(xh, dt, A, Bm, Cm, chunk=chunk)


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul [E,C,D] x [Ew,D,F] -> [E,C,F], slab ``e % Ew``."""
    _no_backward("gmm", x, w)
    if x.device.type == "cpu":
        return ref.gmm_ref(x, w)
    return _gmm.gmm(x, w)


def moe_expert_mlp(expert_in: torch.Tensor, experts: dict, cfg) -> torch.Tensor:
    """SwiGLU expert FFN via grouped matmuls.  expert_in [(G,)E,C,D]."""
    squeeze = expert_in.dim() == 3
    if squeeze:
        expert_in = expert_in[None]
    G, E, C, D = expert_in.shape
    # the dispatch einsum may hand over a permuted view; the kernel reads rows
    x = expert_in.reshape(G * E, C, D).contiguous()
    w_gate = experts["gate"].to(x.dtype)
    w_up = experts["up"].to(x.dtype)
    w_down = experts["down"].to(x.dtype)
    h = F.silu(gmm(x, w_gate)) * gmm(x, w_up)
    out = gmm(h, w_down).reshape(G, E, C, D)
    return out[0] if squeeze else out
