"""The reference's logits at a served batch's served positions.

A served batch is the prompts left-padded to the longest (width W), prefilled
together, then decoded one token a row a step.  The reference runs the whole
sequence at once, teacher-forced on the served tokens: positions 0..W-1 hold
the padded prompts and W..W+n-2 the first n-1 served tokens, and the logits at
W-1..W+n-2 are those from which the n served tokens were chosen.  Mixture-of-
experts groups follow the served path: the prefill's B x W tokens row-major in
``group_count`` groups, then each decode position's B tokens a group.
"""

from __future__ import annotations

import torch

from portbench.reference import model as M


def padded(prompts: list, pad: int) -> torch.Tensor:
    """Prompts (1-D int arrays) left-padded to the longest, [B, W] long."""
    width = max(len(p) for p in prompts)
    out = torch.full((len(prompts), width), pad, dtype=torch.long)
    for i, p in enumerate(prompts):
        out[i, width - len(p):] = torch.as_tensor(p, dtype=torch.long)
    return out


def groups(B: int, W: int, n_new: int, device) -> list:
    """The MoE groups of the flattened [B, W + n_new - 1] sequence."""
    S = W + n_new - 1
    flat = torch.arange(B * S, device=device).view(B, S)
    prefill = flat[:, :W].reshape(-1)
    g = M.group_count(B * W)
    out = list(prefill.view(g, -1))
    out += [flat[:, s] for s in range(W, S)]
    return out


def tape_of_calls(calls: list, B: int, W: int, n_new: int, n_layers: int) -> list:
    """A served run's routing, one (choice, placed) per MoE call in the order
    it ran (the prefill's layers, then each decode step's), laid out as one
    entry a layer over the flattened [B, W + n_new - 1] sequence."""
    S = W + n_new - 1
    tape = []
    for layer in range(n_layers):
        parts = []
        for t in range(2):
            pre = calls[layer][t].reshape(B, W, -1)
            steps = [calls[n_layers * (1 + j) + layer][t].reshape(B, 1, -1)
                     for j in range(n_new - 1)]
            parts.append(torch.cat([pre] + steps, dim=1).reshape(B * S, -1))
        tape.append(tuple(parts))
    return tape


@torch.no_grad()
def served_logits(params: dict, cfg: dict, prompts: list, served: torch.Tensor, pad: int,
                  prec: M.Precision, tape: list | None = None):
    """([B, n, V] f32 logits from which each row's n served tokens were
    chosen, the ``Routing`` it took): its own routing, or ``tape``'s (one
    entry a layer, as ``tape_of_calls`` lays it out)."""
    device = params["embed"]["table"].device
    B, n = served.shape
    prompt = padded(prompts, pad).to(device)
    W = prompt.shape[1]
    seq = torch.cat([prompt, served[:, :-1].to(device)], dim=1)
    # the routing check counts the real tokens' choices: the pad tokens route
    # alike, so one near tie among them moves thousands of choices at once
    starts = torch.tensor([W - len(p) for p in prompts], device=device)
    real = torch.arange(seq.shape[1], device=device)[None, :] >= starts[:, None]
    routing = M.Routing(groups(B, W, n, device), tape, real.reshape(-1)) if "moe" in cfg else None
    x = M.hidden(params, cfg, seq, prec, routing)
    return M.logits(params, cfg, x[:, W - 1:], prec), routing
