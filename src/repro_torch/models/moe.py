"""Mixture-of-Experts: top-k routing with grouped, capacity-bounded dispatch.

Counterpart of ``repro/models/moe.py``.  Tokens are split into groups; each
group builds a ``[T_g, E, C]`` dispatch/combine tensor and sends tokens to the
experts through einsums.  Capacity is rounded up to a multiple of 8; tokens
past an expert's capacity are dropped (their combine weight is zero).  The
reference's ``shard(...)`` annotations are kept: under a mesh the groups go
over the data axes and the experts over "model".  Routing (top-k, the
cumsum over a group's tokens, the slot scatter) has no DTensor sharding
strategy, and the dispatch and combine einsums fold sharded dims that some
DTensor versions cannot split: both run per rank, on its own groups (and
experts), through ``local_map``.

``use_gmm=True`` runs the expert FFN through the grouped-matmul kernel
(:func:`repro_torch.kernels.ops.moe_expert_mlp`).  As in the reference, no
model path sets it: ``apply_block`` calls :func:`apply_moe` without it.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import shard

DEFAULT_GROUP_SIZE = 2048


def init_moe(cfg: ModelConfig):
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_ff, moe.n_experts
    return {
        "router": {"w": ParamSpec((d, e), ("embed", "experts"), scale=1.0)},
        "experts": {
            "gate": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
            "up": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
            "down": ParamSpec((e, f, d), ("experts", "mlp", "embed")),
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


def _route(logits: torch.Tensor, cfg: ModelConfig, capacity: int):
    """:func:`top_k_dispatch`; a DTensor's groups are routed on the rank that
    holds them.  Its other dims are gathered first, the groups keep their
    placement (sharded where the groups are, as the "batch" annotation put
    them), and the aux loss, a mean over groups, is the average of the
    ranks' means (``Partial("avg")`` over the mesh dims sharding the groups)."""
    if not sharding.is_dtensor(logits):
        return top_k_dispatch(logits, cfg, capacity)
    from torch.distributed.tensor import Partial

    groups = sharding.follow(logits.placements, {0: 0})
    aux = tuple(Partial("avg") if p.is_shard() else p for p in groups)
    return sharding.local_map(lambda lg: top_k_dispatch(lg, cfg, capacity),
                              (groups, groups, aux), (groups,), logits.device_mesh)(logits)


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
    xg = shard(xg, "batch", None, "embed")

    logits = xg.float() @ params["router"]["w"].float()  # [G,T,E]
    capacity = capacity_for(tg, cfg)
    dispatch, combine, aux = _route(logits, cfg, capacity)
    dispatch_t = shard(dispatch.to(x.dtype), "batch", None, "experts", None)

    experts = [params["experts"][name] for name in ("gate", "up", "down")]
    combine = combine.to(x.dtype)
    if sharding.is_dtensor(xg):
        out = _experts_per_shard(cfg, use_gmm, xg, dispatch_t, combine, *experts)
    else:
        out = _experts(cfg, use_gmm, xg, dispatch_t, combine, *experts)
    return out.reshape(B, S, D), aux


def _experts(cfg: ModelConfig, use_gmm: bool, xg, dispatch_t, combine, w_gate, w_up, w_down):
    """Dispatch, the expert FFN and the weighted combine: [G,T,D] -> [G,T,D]."""
    # dispatch einsum -> [G, E, C, D]; E sharded over "model" => all-to-all
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch_t, xg)
    expert_in = shard(expert_in, "batch", "experts", "expert_capacity", "embed")

    if use_gmm:
        weights = {"gate": w_gate, "up": w_up, "down": w_down}
        expert_out = kernel_ops.moe_expert_mlp(expert_in, weights, cfg)
    else:
        w_gate, w_up, w_down = (w.to(xg.dtype) for w in (w_gate, w_up, w_down))
        h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, w_gate))
        h = h * torch.einsum("gecd,edf->gecf", expert_in, w_up)
        h = shard(h, "batch", "experts", "expert_capacity", "mlp")
        expert_out = torch.einsum("gecf,efd->gecd", h, w_down)
    expert_out = shard(expert_out, "batch", "experts", None, "embed")

    return torch.einsum("gtec,gecd->gtd", combine, expert_out)


def _experts_per_shard(cfg: ModelConfig, use_gmm: bool, xg, dispatch_t, combine, *weights):
    """:func:`_experts` of DTensors, per rank on the slice of the expert FFN
    that the placement of its hidden ``h`` [G,E,C,F] gives it under the
    rules (``"batch", "experts", "expert_capacity", "mlp"``): its groups, and
    its experts, or, where the experts do not divide the model axis (8 on a
    model axis of 16), its columns of the hidden dim, as the reference's
    joint assignment gives "model" to "mlp" then.  The expert weights are
    gathered along their FSDP-sharded dims.  Each rank's output is its share
    of the combine, a partial sum over the ranks along the experts or the
    hidden dim; xg's and the combine weights' gradients are one there too,
    and the weights' over the ranks along the groups.  DTensor's einsums
    would fold sharded dims into one that some versions cannot split."""
    G, _, E, C = dispatch_t.shape
    F_ = weights[0].shape[-1]
    hp = sharding.act_placements(dispatch_t.new_empty(()).expand(G, E, C, F_),
                                 "batch", "experts", "expert_capacity", "mlp")
    dp = sharding.follow(hp, {0: 0, 1: 2})
    xp = sharding.follow(hp, {0: 0})
    w_in, w_out = sharding.follow(hp, {1: 0, 3: 2}), sharding.follow(hp, {1: 0, 3: 1})
    x_grad = sharding.grad_placements(hp, {0: 0}, {1, 3})
    d_grad = sharding.grad_placements(hp, {0: 0, 1: 2}, {3})
    in_grad, out_grad = (sharding.grad_placements(hp, {1: 0, 3: d}, {0}) for d in (2, 1))
    out = x_grad  # the output is laid out as xg's gradient is
    return sharding.local_map(functools.partial(_experts, cfg, use_gmm), out,
                              (xp, dp, dp, w_in, w_in, w_out), xg.device_mesh,
                              in_grad_placements=(x_grad, d_grad, d_grad,
                                                  in_grad, in_grad, out_grad))(
        xg, dispatch_t, combine, *weights)
