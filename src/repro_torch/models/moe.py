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
experts), through ``local_map``.  One group (at most 2048 tokens, every
decode step) cannot take the data axes; its expert work is split over them
as XLA splits the reference's (:func:`_experts_split`).

Every product by an expert weight is :func:`_expert_product`: an einsum, or
with ``use_gmm=True`` the grouped-matmul kernel
(:func:`repro_torch.kernels.ops.gmm`).  As in the reference, no model path
sets it: ``apply_block`` calls :func:`apply_moe` without it.

``dispatch="dropless"`` (DeepSeek-V3's layer, :func:`apply_dropless`) drops
nothing: each held expert gathers the rows routed to it, and its gated output
is added back where they came from.  The layer may hold a share of the
router's experts (expert parallelism, one chip's share): it routes over all
of them and computes its own experts' part alone.  Beside it run shared
experts, the sequence-wise balance loss and the correction bias
(:class:`Balance`) that the train step moves after each optimizer step.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import shard

DEFAULT_GROUP_SIZE = 2048


def init_moe(cfg: ModelConfig):
    """The router (over ``n_router`` experts), the held experts and, where the
    layer has them, the shared experts as one SwiGLU."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_ff, moe.n_experts
    spec = {
        "router": {"w": ParamSpec((d, moe.n_router), ("embed", "experts"), scale=1.0)},
        "experts": {
            "gate": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
            "up": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
            "down": ParamSpec((e, f, d), ("experts", "mlp", "embed")),
        },
    }
    if moe.n_shared_experts:
        spec["shared"] = L.init_mlp(d, moe.n_shared_experts * f, "swiglu")
    return spec


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
    balance: Balance | None = None,
    layer: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B,S,D], aux_loss scalar).  ``balance`` and ``layer``
    (the layer's index among the stack's MoE layers) are the dropless layer's
    (:func:`apply_dropless`)."""
    if cfg.moe.dispatch == "dropless":
        return apply_dropless(params, cfg, x, balance, layer)
    B, S, D = x.shape
    T = B * S
    groups = group_tokens(T, group_size)
    tg = T // groups
    xg = x.reshape(groups, tg, D)
    xg = shard(xg, "batch", None, "embed")

    with tracing.span("moe.route") as route:
        logits = xg.float() @ params["router"]["w"].float()  # [G,T,E]
        capacity = capacity_for(tg, cfg)
        dispatch, combine, aux = _route(logits, cfg, capacity)
        if tracing.enabled():
            # top-k assignments, and those placed within capacity (summed on the device)
            route.set(assignments=T * cfg.moe.top_k, placed=dispatch.sum())
    dispatch_t = shard(dispatch.to(x.dtype), "batch", None, "experts", None)

    experts = [params["experts"][name] for name in ("gate", "up", "down")]
    combine = combine.to(x.dtype)
    with tracing.span("moe.experts"):
        if sharding.is_dtensor(xg):
            out = _experts_per_shard(use_gmm, xg, dispatch_t, combine, *experts,
                                     rows=B if groups == 1 else None)
        else:
            out = _experts(use_gmm, xg, dispatch_t, combine, *experts)
    return out.reshape(B, S, D), aux


def _dispatch(dispatch_t, xg):
    """The dispatch einsum: [G,T,E,C] x [G,T,D] -> [G,E,C,D]; E sharded over
    "model" => all-to-all."""
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch_t, xg)
    return shard(expert_in, "batch", "experts", "expert_capacity", "embed")


def _combine(combine, expert_out):
    """The weighted combine: [G,T,E,C] x [G,E,C,D] -> [G,T,D]."""
    return torch.einsum("gtec,gecd->gtd", combine, expert_out)


def _experts(use_gmm: bool, xg, dispatch_t, combine, w_gate, w_up, w_down):
    """Dispatch, the expert FFN and the weighted combine of plain tensors
    (:func:`_experts_per_shard` maps it over a mesh's ranks): [G,T,D] -> [G,T,D]."""
    expert_in = _dispatch(dispatch_t, xg)
    weights = [w.to(xg.dtype) for w in (w_gate, w_up, w_down)]
    return _combine(combine, _swiglu(use_gmm, expert_in, *weights))


def _experts_per_shard(use_gmm: bool, xg, dispatch_t, combine, *weights,
                       rows: int | None = None):
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
    would fold sharded dims into one that some versions cannot split.

    Where one group (at most 2048 tokens, as every decode step has) cannot
    take a batch axis, its ranks split the work as XLA splits the
    reference's (:func:`_experts_split`), if the embed dim and the ``rows``
    of x the group's tokens come from divide among them."""
    G, _, E, C = dispatch_t.shape
    F_ = weights[0].shape[-1]
    mesh = xg.device_mesh
    hp = sharding.act_placements(dispatch_t.new_empty(()).expand(G, E, C, F_),
                                 "batch", "experts", "expert_capacity", "mlp")
    split = sharding.untaken_axes(hp, mesh, "batch", xg.shape[-1], rows) if rows else []
    if split:
        return _experts_split(use_gmm, hp, split, xg, dispatch_t, combine, *weights)
    dp = sharding.follow(hp, {0: 0, 1: 2})
    xp = sharding.follow(hp, {0: 0})
    w_in, w_out = sharding.follow(hp, {1: 0, 3: 2}), sharding.follow(hp, {1: 0, 3: 1})
    x_grad = sharding.grad_placements(hp, {0: 0}, {1, 3})
    d_grad = sharding.grad_placements(hp, {0: 0, 1: 2}, {3})
    in_grad, out_grad = (sharding.grad_placements(hp, {1: 0, 3: d}, {0}) for d in (2, 1))
    out = x_grad  # the output is laid out as xg's gradient is
    return sharding.local_map(functools.partial(_experts, use_gmm), out,
                              (xp, dp, dp, w_in, w_in, w_out), mesh,
                              in_grad_placements=(x_grad, d_grad, d_grad,
                                                  in_grad, in_grad, out_grad))(
        xg, dispatch_t, combine, *weights)


def _expert_product(use_gmm: bool, x, w):
    """[G,E,C,K] x [E,K,N] -> [G,E,C,N], through the grouped-matmul kernel
    with ``use_gmm``."""
    if use_gmm:
        G, E, C, K = x.shape
        out = kernel_ops.gmm(x.reshape(G * E, C, K).contiguous(), w.to(x.dtype))
        return out.reshape(G, E, C, -1)
    return torch.einsum("geck,ekn->gecn", x, w.to(x.dtype))


def _swiglu(use_gmm: bool, x, w_gate, w_up, w_down):
    """Each expert's SwiGLU of its rows x [G,E,C,D] -> [G,E,C,D]."""
    h = F.silu(_expert_product(use_gmm, x, w_gate)) * _expert_product(use_gmm, x, w_up)
    return _expert_product(use_gmm, h, w_down)


def _experts_split(use_gmm: bool, hp: tuple, split: list[int], xg, dispatch_t, combine,
                   w_gate, w_up, w_down):
    """:func:`_experts_per_shard` of one group [1,T,...] where the mesh dims
    ``split`` would take the groups but cannot: their ranks hold every token
    of the group, and split its work as XLA splits the reference's, in four
    steps per rank:

    * the dispatch, whole;
    * the gate and up products on the rank's slice of the embed dim, where
      the expert weights already are (FSDP): partial sums, reduced over
      ``split`` before the SwiGLU;
    * the down product on the rank's slice of the embed dim: its columns of
      the expert outputs, gathered for
    * the combine, of the rank's slice of the tokens.

    Every token is routed on every rank (:func:`_route`), and no expert
    weight moves along ``split``: only the hidden [G,E,C,F] is reduced and
    the expert outputs [G,E,C,D] gathered, which at decode are far smaller
    than the weights."""
    from torch.distributed.tensor import Shard

    # hp with the split mesh dims shown as sharding a dim of their own, 4:
    # follow(hs, {1: a, 3: b, 4: c}) shards dim a where the experts' mesh
    # dims are, b where the hidden dim's are, c along the split
    hs = tuple(Shard(4) if i in split else p for i, p in enumerate(hp))
    fol, grad = sharding.follow, sharding.grad_placements
    mesh = xg.device_mesh
    expert_in = sharding.local_map(
        _dispatch, fol(hs, {1: 1}), (fol(hs, {1: 2}), fol(hs, {})), mesh,
        in_grad_placements=(None, grad(hs, {}, {1})))(dispatch_t, xg)

    w_in = fol(hs, {1: 0, 3: 2, 4: 1})
    gate_up = sharding.local_map(
        lambda x, wg, wu: (_expert_product(use_gmm, x, wg), _expert_product(use_gmm, x, wu)),
        (grad(hs, {1: 1, 3: 3}, {4}),) * 2, (fol(hs, {1: 1, 4: 3}), w_in, w_in), mesh,
        in_grad_placements=(grad(hs, {1: 1, 4: 3}, {3}), None, None))(
        expert_in, w_gate, w_up)

    def down(g, u, w):
        return _expert_product(use_gmm, F.silu(g) * u, w)

    hidden = fol(hs, {1: 1, 3: 3})
    expert_out = sharding.local_map(
        down, grad(hs, {1: 1, 4: 3}, {3}), (hidden, hidden, fol(hs, {1: 0, 3: 1, 4: 2})), mesh,
        in_grad_placements=(grad(hs, {1: 1, 3: 3}, {4}),) * 2 + (None,))(*gate_up, w_down)

    return sharding.local_map(
        _combine, grad(hs, {4: 1}, {1, 3}), (fol(hs, {1: 2, 4: 1}), grad(hs, {1: 1}, {3})),
        mesh, in_grad_placements=(grad(hs, {1: 2, 4: 1}, {3}), grad(hs, {1: 1}, {4})))(
        combine, expert_out)


# ---------------------------------------------------------------------------
# Dropless dispatch over a held share of the router's experts (DeepSeek-V3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Balance:
    """DeepSeek-V3's auxiliary-loss-free balancing (arXiv:2412.19437 §2.1.2)
    of a stack's MoE layers: ``bias`` [L, n_router] f32, each router's
    correction bias, which moves the selection alone (no gradient reaches
    it, and the optimizer leaves it be), and ``load``, each layer's expert
    counts [n_router] of the forward that routed there last.  A remat's
    recompute routes the same tokens again and writes the same counts."""

    bias: torch.Tensor
    load: dict = dataclasses.field(default_factory=dict)
    total: torch.Tensor | None = None

    def end_forward(self) -> None:
        """Adds the counts of the forward just done (a microbatch's) to the step's."""
        load = torch.stack([self.load[i] for i in range(self.bias.shape[0])])
        self.total = load if self.total is None else self.total + load
        self.load = {}

    @torch.no_grad()
    def update_(self, gamma: float) -> None:
        """After the optimizer step: b_i += gamma * sign(mean load - load_i),
        each layer over the step's counts, then the counts cleared."""
        with tracing.span("moe.balance") as s:
            load = self.total.float()
            self.bias.add_(gamma * torch.sign(load.mean(-1, keepdim=True) - load))
            self.total = None
            if tracing.enabled():
                s.set(bias_abs_max=self.bias.abs().max())


def select_experts(logits: torch.Tensor, cfg: ModelConfig,
                   bias: torch.Tensor | None = None):
    """(choice [N, k] expert ids among the router's, gates [N, k] f32, scores
    [N, E] f32) of router logits [N, E] f32.  ``softmax``: the top k logits,
    their softmax the gates; ``sigmoid``: s = sigmoid(logits), the top k of
    s + bias (the bias picks, it weighs nothing), the gates s at the chosen
    over their sum times ``routed_scale``."""
    moe = cfg.moe
    if moe.score_func == "softmax":
        vals, choice = torch.topk(logits, moe.top_k, dim=-1)
        return choice, torch.softmax(vals, dim=-1), torch.softmax(logits, dim=-1)
    scores = torch.sigmoid(logits)
    pick = scores if bias is None else scores + bias
    choice = torch.topk(pick, moe.top_k, dim=-1).indices
    gates = scores.gather(-1, choice)
    gates = gates / gates.sum(-1, keepdim=True)
    return choice, gates * moe.routed_scale, scores


def sequence_balance_loss(scores: torch.Tensor, counts: torch.Tensor, cfg: ModelConfig):
    """DeepSeek-V3's sequence-wise balance loss (eqs. 17-20) before alpha, the
    mean over sequences: sum_i f_i P_i, f_i = E / (k S) times the tokens
    choosing i, P_i the mean over the sequence of i's score over the token's
    sum.  scores [B, S, E] f32; counts [B, E] (a constant)."""
    E, k = scores.shape[-1], cfg.moe.top_k
    f = counts.float() * (E / (k * scores.shape[1]))
    p = (scores / scores.sum(-1, keepdim=True)).mean(1)
    return (f * p).sum(-1).mean()


def apply_dropless(params, cfg: ModelConfig, x: torch.Tensor, balance: Balance | None,
                   layer: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer without capacity: x [B, S, D] -> (shared experts + the
    held experts' gated outputs [B, S, D], aux).  The router scores all
    ``n_router`` experts; the layer computes the rows routed to the
    ``n_experts`` it holds (from ``first_expert`` on), and what the others
    would add is left out.  The held rows are gathered in expert order
    (one sort of the choices, one read of the counts to the host), run
    through each expert's SwiGLU and added back with their gates: no tensor
    scales with tokens x experts x capacity (the experts' slab is padded to
    the busiest held expert's rows alone).  aux: the sequence-wise
    balance loss for sigmoid scores, the Switch loss for softmax ones."""
    moe = cfg.moe
    B, S, D = x.shape
    N, k, E = B * S, moe.top_k, moe.n_router
    lo, held = moe.first_expert, moe.n_experts
    if sharding.is_dtensor(x):
        raise NotImplementedError("dropless dispatch runs on one device's tensors")
    xf = x.reshape(N, D)
    with tracing.span("moe.route") as route:
        logits = xf.float() @ params["router"]["w"].float()            # [N, E]
        bias = balance.bias[layer] if balance is not None else None
        choice, gates, scores = select_experts(logits, cfg, bias)
        per_row = torch.zeros((B, E), dtype=torch.int64, device=x.device).scatter_add_(
            1, choice.reshape(B, S * k), torch.ones_like(choice).reshape(B, S * k))
        counts = per_row.sum(0)
        if balance is not None:
            balance.load[layer] = counts
        if moe.score_func == "sigmoid":
            aux = sequence_balance_loss(scores.reshape(B, S, E), per_row, cfg)
        else:
            aux = E * torch.sum(scores.mean(0) * F.one_hot(choice[:, 0], E).float().mean(0))
        # the held experts' rows, in expert order: one sort of the choices
        order = torch.argsort(choice.reshape(-1), stable=True)
        host = counts.tolist()
        start, rows = sum(host[:lo]), host[lo:lo + held]
        mine = order[start:start + sum(rows)]
        if tracing.enabled():
            route.set(held_rows=sum(rows), held_max_rows=max(rows), held_experts=held)
    if "shared" in params:
        with tracing.span("moe.shared") as s:
            out = s.grad_out(L.apply_mlp(params["shared"], s.grad_in(xf), "swiglu")).float()
    else:
        out = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    with tracing.span("moe.experts") as s:
        widest = max(rows)
        if widest:
            # the held rows, in expert order, each to its slot of a zero-padded
            # slab [1, held, widest, D]: three batched products run every held
            # expert at once, where products an expert at a time would run at
            # the pace the host launches them
            tokens = mine // k
            local = choice.reshape(-1)[mine] - lo
            first = torch.cumsum(counts[lo:lo + held], 0) - counts[lo:lo + held]
            slot = local * widest + torch.arange(len(mine), device=x.device) - first[local]
            slab = xf.new_zeros(held * widest, D).index_copy(0, slot, s.grad_in(xf)[tokens])
            weights = [params["experts"][n].to(x.dtype) for n in ("gate", "up", "down")]
            y = _swiglu(False, slab.view(1, held, widest, D), *weights)
            y = y.reshape(held * widest, D)[slot]
            y = y.float() * gates.reshape(-1)[mine, None]
            out = out.index_add(0, tokens, s.grad_out(y))
    return out.to(x.dtype).reshape(B, S, D), aux
