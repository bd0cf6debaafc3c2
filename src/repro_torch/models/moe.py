"""Mixture-of-Experts: top-k routing with grouped, capacity-bounded dispatch.

Counterpart of ``repro/models/moe.py``.  Tokens are split into groups; each
group builds a ``[T_g, E, C]`` dispatch/combine tensor and sends tokens to the
experts through einsums.  Capacity is rounded up to a multiple of 8; tokens
past an expert's capacity are dropped (their combine weight is zero).  The
reference's ``shard(...)`` annotations are no-ops without a mesh and are left
out; sharding is a later slice (see ROADMAP.md).

``use_gmm=True`` runs the expert FFN through the grouped-matmul kernel
(:func:`repro_torch.kernels.ops.moe_expert_mlp`).  As in the reference, no
model path sets it: ``apply_block`` calls :func:`apply_moe` without it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import ParamSpec

DEFAULT_GROUP_SIZE = 2048


def init_moe(cfg: ModelConfig):
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_ff, moe.n_experts
    return {
        "router": {"w": ParamSpec((d, e), scale=1.0)},
        "experts": {
            "gate": ParamSpec((e, d, f)),
            "up": ParamSpec((e, d, f)),
            "down": ParamSpec((e, f, d)),
        },
    }


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity_for(tokens_per_group: int, cfg: ModelConfig) -> int:
    moe = cfg.moe
    c = int(tokens_per_group * moe.top_k * moe.capacity_factor / moe.n_experts)
    return max(_round_up(max(c, 1), 8), 8)


def group_tokens(n_tokens: int, group_size: int = DEFAULT_GROUP_SIZE) -> int:
    """Number of dispatch groups (must divide the token count)."""
    groups = max(1, n_tokens // group_size)
    while n_tokens % groups:
        groups -= 1
    return groups


def top_k_dispatch(logits: torch.Tensor, cfg: ModelConfig, capacity: int):
    """Dispatch/combine tensors per group from router logits [G,T,E] (f32).

    Returns (dispatch [G,T,E,C] bool, combine [G,T,E,C] f32, aux_loss).  Slots
    fill in k-major order: every token's first choice, then every token's
    second, each choice's slot the number of earlier tokens (exclusive cumsum
    over T) that took that expert, plus what earlier choices filled.
    """
    moe = cfg.moe
    G, T, E = logits.shape
    k = moe.top_k
    probs = torch.softmax(logits, dim=-1)  # [G,T,E] f32

    gate_vals, expert_idx = torch.topk(logits, k, dim=-1)  # [G,T,k], descending
    gates = torch.softmax(gate_vals, dim=-1)  # normalised over the top-k

    counts = torch.zeros((G, E), dtype=torch.int64, device=logits.device)
    dispatch = torch.zeros((G, T, E, capacity), dtype=torch.bool, device=logits.device)
    combine = torch.zeros((G, T, E, capacity), dtype=torch.float32, device=logits.device)
    for j in range(k):
        onehot = F.one_hot(expert_idx[..., j], E)  # [G,T,E] int64
        pos = counts[:, None, :] + torch.cumsum(onehot, dim=1) - onehot
        fits = (pos < capacity) & (onehot > 0)
        counts = counts + onehot.sum(dim=1)
        # jax.nn.one_hot(pos, capacity) is all zero where pos >= capacity;
        # F.one_hot would raise there, so the slot is scattered where it fits
        slot = torch.where(fits, pos, 0).unsqueeze(-1)
        placed = torch.zeros_like(combine).scatter_(-1, slot, fits.unsqueeze(-1).float())
        dispatch = dispatch | (placed > 0)
        combine = combine + gates[..., j, None, None] * placed

    # Switch-style load-balance auxiliary loss
    me = probs.mean(dim=1)                                       # [G,E] mean router prob
    ce = F.one_hot(expert_idx[..., 0], E).float().mean(dim=1)    # top-1 proxy
    aux = E * torch.mean(torch.sum(me * ce, dim=-1))
    return dispatch, combine, aux


def apply_moe(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, D]
    group_size: int = DEFAULT_GROUP_SIZE,
    use_gmm: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B,S,D], aux_loss scalar)."""
    B, S, D = x.shape
    T = B * S
    groups = group_tokens(T, group_size)
    tg = T // groups
    xg = x.reshape(groups, tg, D)

    logits = xg.float() @ params["router"]["w"].float()  # [G,T,E]
    capacity = capacity_for(tg, cfg)
    dispatch, combine, aux = top_k_dispatch(logits, cfg, capacity)
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xg)

    if use_gmm:
        expert_out = kernel_ops.moe_expert_mlp(expert_in, params["experts"], cfg)
    else:
        w_gate = params["experts"]["gate"].to(x.dtype)
        w_up = params["experts"]["up"].to(x.dtype)
        w_down = params["experts"]["down"].to(x.dtype)
        h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, w_gate))
        h = h * torch.einsum("gecd,edf->gecf", expert_in, w_up)
        expert_out = torch.einsum("gecf,efd->gecd", h, w_down)

    out = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), expert_out)
    return out.reshape(B, S, D), aux
