"""A plain float32 DeepSeek-V3 language model (Moonlight-16B-A3B's block), its
first training steps computed a row's graph at a time, as ``train.py``
computes internlm2's.

Written from arXiv:2412.19437 (§2.1.1 latent attention, §2.1.2 the MoE with
auxiliary-loss-free balancing, eqs. 17-20 the sequence-wise balance loss,
§4.2 alpha and gamma) and the released ``config.json``: RMSNorm before
attention and before the FFN; latent attention without q compression (q per
head as [q_nope; q_pe], [c_kv; k_pe] from one down-projection, c_kv through
its own RMSNorm, [k_nope; v] per head from c_kv, one k_pe for every head,
softmax scale 1/sqrt(nope + rope), causal); the first ``first_dense_layers``
blocks a SwiGLU, the rest a mixture: sigmoid scores s, the top k of s + b
(b the router's correction bias), gates the chosen s over their sum times
``routed_scale``, plus the shared experts as one SwiGLU; a final RMSNorm, an
untied head.  The loss is the mean next-token cross-entropy plus alpha times
each MoE layer's balance loss (the mean over the rows of sum_i f_i P_i),
summed over the layers; after each AdamW step (``train.py``'s) each bias
takes b_i += gamma * sign(mean load - load_i) over the step's choices.

Departures, each the program's semantics, which the reference follows so that
the two compute the same function:

* RoPE rotates the first half of a head's rotary part with the second (the
  split-half layout); the released code de-interleaves q_pe and k_pe first,
  a fixed permutation of W's columns on drawn weights;
* the layer holds ``n_experts`` of the router's ``router_experts`` (from
  ``first_expert`` on): it routes over all of them and adds only its own
  experts' part, the deployment's one chip of eight;
* routing is a step function of the scores: where the program's bf16
  rounding moves a near tie, an expert's rows change and its leaves'
  gradients with them.  So the reference can follow the routing the
  program took (a tape of each MoE call's choices), computing the gates from
  its own scores at those choices, and check that routing by itself
  (``Routing``).

Weights are the benchmark's own tensors by their keys (``blocks`` stacked over
the MoE layers, ``dense_blocks`` over the leading dense ones).  Every product
goes through ``Precision`` so that the control can compute the same function
in a lower precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.harness.weights import leaves
from portbench.reference import model as M
from portbench.reference.train import _lr, _norms, _unflat


class Routing:
    """The MoE calls of one step: each call's (layer, row) routed once, a
    remat's second pass writing the same.  ``tape``: one entry a MoE layer,
    the program's choices [B * S, k] over the flattened batch, which the
    experts then take; each call keeps its check: the widest gap by which a
    chosen expert's s + b lies below this side's k-th best, and the choices
    not among this side's own top k."""

    def __init__(self, seq: int, tape: list | None = None):
        self.seq, self.tape = seq, tape
        self.calls: dict = {}

    def route(self, pick: torch.Tensor, k: int, layer: int, row: int) -> torch.Tensor:
        """choice [S, k] for s + b ``pick`` [S, E] of one row in one layer."""
        top = torch.topk(pick, k, dim=-1)
        if self.tape is None:
            choice = top.indices
        else:
            rows = slice(row * self.seq, (row + 1) * self.seq)
            choice = self.tape[layer][rows].to(pick.device).long()
        margin = float((top.values[:, -1] - pick.gather(1, choice).amin(-1)).max())
        off = int((choice[:, :, None] != top.indices[:, None, :]).all(-1).sum())
        self.calls[(layer, row)] = (choice, margin, off)
        return choice

    def counts(self, n_layers: int, n_router: int) -> torch.Tensor:
        """[L, E] the step's choices of each expert, every row's."""
        out = []
        for layer in range(n_layers):
            mine = [c for (lay, _), (c, _, _) in self.calls.items() if lay == layer]
            out.append(sum(torch.bincount(c.reshape(-1), minlength=n_router) for c in mine))
        return torch.stack(out)

    def taken(self, n_layers: int) -> list:
        """The step's choices as a tape, one [rows * S, k] uint8 a layer."""
        rows = sorted({row for _, row in self.calls})
        return [torch.cat([self.calls[(layer, r)][0] for r in rows]).to(torch.uint8)
                for layer in range(n_layers)]


def mla(p: dict, cfg: dict, x: torch.Tensor, prec: M.Precision) -> torch.Tensor:
    """Causal latent attention of x [B, S, d] at positions 0..S-1."""
    B, S, _ = x.shape
    H, r = cfg["n_heads"], cfg["kv_lora_rank"]
    nope, rp, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    pos = torch.arange(S, device=x.device)
    q = prec.mm(x, p["wq"]["w"]).view(B, S, H, nope + rp)
    a = prec.mm(x, p["wkv_a"]["w"])
    c_kv = M.rms_norm(a[..., :r], p["kv_norm"]["scale"], cfg["norm_eps"])
    k_pe = M.rope(a[..., r:].reshape(B, S, 1, rp), pos, cfg["rope_theta"])
    kv = prec.mm(c_kv, p["wkv_b"]["w"]).view(B, S, H, nope + dv)
    q = torch.cat([q[..., :nope], M.rope(q[..., nope:], pos, cfg["rope_theta"])], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(B, S, H, rp)], dim=-1)
    v = kv[..., nope:]
    allowed = pos[None, :] <= pos[:, None]
    rows = []
    for b in range(B):
        scores = prec.einsum("shd,thd->hst", q[b], k[b]) / (nope + rp) ** 0.5
        probs = torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)
        rows.append(prec.einsum("hst,thd->shd", probs, v[b]).reshape(S, H * dv))
    return prec.mm(torch.stack(rows), p["wo"]["w"])


def moe(p: dict, cfg: dict, x: torch.Tensor, bias: torch.Tensor, routing: Routing,
        layer: int, row: int, prec: M.Precision):
    """(the shared experts plus the held experts' gated outputs [S, d], the
    row's balance loss before alpha) for one row's tokens x [S, d]."""
    m = cfg["moe"]
    S = x.shape[0]
    E, k = m.get("router_experts") or m["n_experts"], m["top_k"]
    lo = m.get("first_expert", 0)
    s = torch.sigmoid(prec.mm(x, p["router"]["w"]))            # [S, E]
    choice = routing.route((s + bias).detach(), k, layer, row)
    gates = s.gather(1, choice)
    gates = gates / gates.sum(-1, keepdim=True) * m["routed_scale"]
    sh = p["shared"]
    out = M.swiglu(x, sh["gate"]["w"], sh["up"]["w"], sh["down"]["w"], prec)
    w = p["experts"]
    for e in range(m["n_experts"]):
        hit = choice == lo + e                                  # [S, k]
        tokens = hit.any(-1).nonzero()[:, 0]
        if len(tokens) == 0:
            continue
        gate = (gates * hit).sum(-1)[tokens]
        y = M.swiglu(x[tokens], w["gate"][e], w["up"][e], w["down"][e], prec)
        out = out.index_add(0, tokens, gate[:, None] * y)
    f = torch.bincount(choice.reshape(-1), minlength=E).float() * (E / (k * S))
    P = (s / s.sum(-1, keepdim=True)).mean(0)
    return out, (f * P).sum()


def block(p: dict, cfg: dict, x: torch.Tensor, bias, routing, layer, row, prec):
    """(x after the block, its balance loss before alpha: 0 for a dense one)."""
    eps = cfg["norm_eps"]
    x = x + mla(p["attn"], cfg, M.rms_norm(x, p["attn_norm"]["scale"], eps), prec)
    h = M.rms_norm(x, p["mlp_norm"]["scale"], eps)
    if "moe" in p:
        out, bal = moe(p["moe"], cfg, h[0], bias, routing, layer, row, prec)
        return x + out[None], bal
    mlp = p["mlp"]
    return x + M.swiglu(h, mlp["gate"]["w"], mlp["up"]["w"], mlp["down"]["w"], prec), \
        torch.zeros((), device=x.device)


def _pick(tree, i):
    return {k: _pick(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def row_loss(params: dict, cfg: dict, bias: torch.Tensor, tokens, labels, routing: Routing,
             row: int, prec: M.Precision) -> torch.Tensor:
    """One row's loss: its tokens' mean cross-entropy plus alpha times its
    balance loss summed over the MoE layers; each block recomputed in the
    backward, so that one row's graph of the stack fits beside the weights
    and the AdamW state."""
    x = params["embed"]["table"][tokens]
    n_dense = cfg.get("first_dense_layers", 0)
    balance = 0.0
    for i in range(cfg["n_layers"]):
        dense = i < n_dense
        p = _pick(params["dense_blocks"] if dense else params["blocks"],
                  i if dense else i - n_dense)
        layer = -1 if dense else i - n_dense
        b = None if dense else bias[layer]
        x, bal = checkpoint(block, p, cfg, x, b, routing, layer, row, prec, use_reentrant=False)
        balance = balance + bal
    lg = M.logits(params, cfg, x, prec)
    ce = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))
    return ce + cfg["moe"]["balance_alpha"] * balance


def follow(params0: dict, cfg: dict, tcfg: dict, batches: list, n_steps: int,
           prec: M.Precision, tapes: list | None = None, rows: slice | None = None) -> dict:
    """``n_steps`` steps from ``params0`` (left unchanged) and zero biases on
    ``batches`` (numpy {"tokens", "labels"} [B, S]): each AdamW (``train.py``'s)
    then the bias update.  ``tapes``: each step's routing to follow (one entry
    a MoE layer); ``rows`` keeps a slice of each batch's rows.  Returns each
    step's loss, each leaf's gradient norm at step 1 as AdamW gets it, each
    leaf's change after the steps, the biases after them, the routing's
    checks (``margins``, the worst call's a step; ``off_choices`` of
    ``n_choices``) and ``tapes``, the routing taken."""
    m_cfg = cfg["moe"]
    E = m_cfg.get("router_experts") or m_cfg["n_experts"]
    n_moe = cfg["n_layers"] - cfg.get("first_dense_layers", 0)
    named0 = {"/".join(p): t for p, t in leaves(params0)}
    p = {k: t.detach().clone().requires_grad_(True) for k, t in named0.items()}
    m = {k: torch.zeros_like(t) for k, t in named0.items()}
    v = {k: torch.zeros_like(t) for k, t in named0.items()}
    b1, b2, eps, wd = tcfg["beta1"], tcfg["beta2"], tcfg["eps"], tcfg["weight_decay"]
    device = next(iter(named0.values())).device
    bias = torch.zeros((n_moe, E), dtype=torch.float32, device=device)
    out = {"losses": [], "grad_norms": None, "margins": [], "off_choices": 0, "n_choices": 0,
           "tapes": []}
    for step in range(n_steps):
        tokens = np.asarray(batches[step]["tokens"])
        labels = np.asarray(batches[step]["labels"])
        if rows is not None:
            tokens, labels = tokens[rows], labels[rows]
        B, S = tokens.shape
        routing = Routing(S, tapes[step] if tapes is not None else None)
        tree = _unflat((tuple(k.split("/")), t) for k, t in p.items())
        total = 0.0
        for r in range(B):
            tok = torch.as_tensor(tokens[r:r + 1], dtype=torch.long, device=device)
            lab = torch.as_tensor(labels[r:r + 1], dtype=torch.long, device=device)
            loss = row_loss(tree, cfg, bias, tok, lab, routing, r, prec)
            (loss / B).backward()
            total += float(loss.detach())
        out["losses"].append(total / B)
        out["margins"].append(max(c[1] for c in routing.calls.values()))
        out["off_choices"] += sum(c[2] for c in routing.calls.values())
        out["n_choices"] += sum(c[0].numel() for c in routing.calls.values())
        out["tapes"].append(routing.taken(n_moe))
        with torch.no_grad():
            grads = {k: t.grad for k, t in p.items()}
            norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
            scale = min(tcfg["max_grad_norm"] / max(norm, 1e-9), 1.0)
            lr = _lr(tcfg, step)
            if step == 0:
                out["grad_norms"] = _norms({k: g * scale for k, g in grads.items()})
            for k, t in p.items():
                g = grads[k] * scale
                m[k].mul_(b1).add_((1 - b1) * g)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                m_hat = m[k] / (1 - b1 ** (step + 1))
                v_hat = v[k] / (1 - b2 ** (step + 1))
                t.sub_(lr * (m_hat / (torch.sqrt(v_hat) + eps) + wd * t))
                t.grad = None
            load = routing.counts(n_moe, E).float()
            bias += m_cfg["bias_update"] * torch.sign(load.mean(-1, keepdim=True) - load)
        del routing, tree
    with torch.no_grad():
        out["change_norms"] = _norms({k: p[k] - named0[k] for k in p})
    out["bias"] = bias
    return out

