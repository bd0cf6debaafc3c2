"""The reference's first training steps: the loss, the gradient as AdamW gets
it and the parameters' change, from the benchmark's initial weights.

The loss is the mean next-token cross-entropy over every position of the
batch (one row's graph at a time, the gradients summed, so that it fits
beside the program's freed state).  AdamW follows the published algorithm
(Loshchilov and Hutter, decoupled weight decay inside the learning-rate
product) with bias correction, after clipping the gradient to a global norm;
the learning rate warms up linearly, lr * (step + 1) / warmup_steps, then
follows a cosine to 0 at total_steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness.weights import leaves
from portbench.reference import model as M


def _lr(tcfg: dict, step: int) -> float:
    lr, warm, total = tcfg["learning_rate"], tcfg["warmup_steps"], tcfg["total_steps"]
    if step < warm:
        return lr * (step + 1) / max(warm, 1)
    progress = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return 0.5 * lr * (1 + math.cos(math.pi * progress))


def _unflat(pairs):
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _norms(named: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in named.items()}


def follow(params0: dict, cfg: dict, tcfg: dict, batches: list, n_steps: int,
           prec: M.Precision, rows: slice | None = None) -> dict:
    """``n_steps`` AdamW steps from ``params0`` (left unchanged) on ``batches``
    (numpy {"tokens", "labels"} [B, S]); ``rows`` keeps a slice of each
    batch's rows.  Returns each step's loss, each leaf's gradient norm at step
    1 as AdamW gets it (clipped), and each leaf's change after the steps."""
    named0 = {"/".join(p): t for p, t in leaves(params0)}
    p = {k: t.detach().clone().requires_grad_(True) for k, t in named0.items()}
    m = {k: torch.zeros_like(t) for k, t in named0.items()}
    v = {k: torch.zeros_like(t) for k, t in named0.items()}
    b1, b2, eps, wd = tcfg["beta1"], tcfg["beta2"], tcfg["eps"], tcfg["weight_decay"]
    device = next(iter(named0.values())).device
    losses, grad_norms = [], None
    for step in range(n_steps):
        tokens = np.asarray(batches[step]["tokens"])
        labels = np.asarray(batches[step]["labels"])
        if rows is not None:
            tokens, labels = tokens[rows], labels[rows]
        B = tokens.shape[0]
        tree = _unflat((tuple(k.split("/")), t) for k, t in p.items())
        total = 0.0
        for b in range(B):
            tok = torch.as_tensor(tokens[b:b + 1], dtype=torch.long, device=device)
            lab = torch.as_tensor(labels[b:b + 1], dtype=torch.long, device=device)
            x = M.hidden(tree, cfg, tok, prec)
            lg = M.logits(tree, cfg, x, prec)
            loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), lab.reshape(-1))
            (loss / B).backward()
            total += float(loss.detach())
        losses.append(total / B)
        with torch.no_grad():
            grads = {k: t.grad for k, t in p.items()}
            norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
            scale = min(tcfg["max_grad_norm"] / max(norm, 1e-9), 1.0)
            lr = _lr(tcfg, step)
            if step == 0:
                grad_norms = _norms({k: g * scale for k, g in grads.items()})
            for k, t in p.items():
                g = grads[k] * scale
                m[k].mul_(b1).add_((1 - b1) * g)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                m_hat = m[k] / (1 - b1 ** (step + 1))
                v_hat = v[k] / (1 - b2 ** (step + 1))
                t.sub_(lr * (m_hat / (torch.sqrt(v_hat) + eps) + wd * t))
                t.grad = None
    with torch.no_grad():
        change = _norms({k: p[k] - named0[k] for k in p})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
