"""AdamW, the warmup-cosine schedule and clipping by global norm: counterpart of
``repro/train/optimizer.py:18-91``, in the reference's exact arithmetic.

Parameters, gradients and the moments are nested dicts of tensors (the
params' layout); m and v are f32 whatever the params' dtype.  The update runs
in place on the params and the moments (the reference returns new arrays):
at internlm2-1.8b a second copy of params, m and v would take 22.7 GB more of
the card.  Each leaf's arithmetic is the reference's, op for op, through
temporaries of that leaf's size, m and v updated in place.  The learning
rate is a tensor computed from the step tensor on the params' device, so a
step needs no host sync.

The leaves may be DTensors (sharded training): m and v then take their
params' placements, the gradients must come in those placements too
(:func:`repro_torch.train.loop.make_train_step` puts them there), and the
global norm, a sum over every rank's shards, is reduced before it scales
anything.  The step stays a plain tensor, the same on every rank.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models import layers as L
from repro_torch.parallel import sharding


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-dim int32
    m: dict             # f32, params' structure
    v: dict             # f32, params' structure


def init_adamw(params) -> AdamWState:
    zeros = L.map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = next(L.flatten_specs(params))[1].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                      v=L.map_tree(torch.clone, zeros))


def cosine_schedule(cfg: TrainConfig):
    """``lr(step)``: linear warmup ``lr * (step + 1) / warmup``, then a cosine
    from ``lr`` down to 0 at ``total_steps``; f32 tensors in and out."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = cfg.learning_rate * (step + 1) / max(cfg.warmup_steps, 1)
        total = max(cfg.total_steps - cfg.warmup_steps, 1)
        progress = torch.clamp((step - cfg.warmup_steps) / total, 0.0, 1.0)
        cos = 0.5 * cfg.learning_rate * (1 + torch.cos(math.pi * progress))
        return torch.where(step < cfg.warmup_steps, warm, cos)

    return lr


def global_norm(tree) -> torch.Tensor:
    """The l2 norm over every leaf, a plain tensor: a DTensor leaf's sum of
    squares is a partial sum over its shards, reduced before the root."""
    total = sum(sharding.full_tensor(torch.sum(torch.square(x.float())))
                for _, x in L.flatten_specs(tree))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global norm is at most ``max_norm``, each
    leaf back in its own dtype; the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return L.map_tree(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: TrainConfig):
    """One AdamW step, in place.  Returns (params, new_state,
    {"grad_norm", "lr"}): ``params`` and the state's m and v are the tensors
    passed in, updated; the step is a new tensor.  The gradients are clipped
    leaf by leaf as :func:`clip_by_global_norm` clips them (each rounded back
    to its own dtype), without a clipped copy of the whole tree."""
    grad_norm = global_norm(grads)
    scale = torch.clamp(cfg.max_grad_norm / torch.clamp(grad_norm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg)(state.step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    leaves = [list(L.flatten_specs(t)) for t in (params, grads, state.m, state.v)]
    with sharding.implicit_replication():  # the scalars meet DTensor leaves
        for (_, p), (_, g), (_, m), (_, v) in zip(*leaves):
            g32 = (g.float() * scale).to(g.dtype).float()
            # m and v take their new values in place, through the same products
            # and sums, and each temporary goes once spent: a leaf holds some
            # four temporaries of its size at once, not nine (an expert leaf of
            # moonlight-16b-a3b is 2.4 GB)
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            del g32
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            p32 = p.float()
            # decoupled weight decay inside the lr product, as the reference has it
            p.copy_(p32 - lr * (delta + cfg.weight_decay * p32))
    return params, AdamWState(step, state.m, state.v), {"grad_norm": grad_norm, "lr": lr}
