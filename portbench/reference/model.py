"""A plain float32 decoder-only transformer: InternLM2's dense blocks and
Mixtral's sparse-expert blocks.

Written from the published descriptions (InternLM2: arXiv:2403.17297 and the
released ``modeling_internlm2.py``; Mixtral: arXiv:2401.04088): RMSNorm before
attention and before the FFN, grouped-query attention with rotary positions
(the split-half rotation of the released code, theta from the
configuration), causal and within the sliding window, a SwiGLU FFN or a
top-2 mixture of SwiGLU experts, a final RMSNorm and an untied output head.

Departures, each the served program's own semantics, which the reference
follows so that the two compute the same function:

* Mixtral's experts take at most a capacity of tokens per group of tokens
  (``capacity``: tokens x top_k x capacity_factor / experts, rounded up to a
  multiple of 8); slots fill every token's first choice, then every token's
  second, in token order within the group; a token past an expert's capacity
  gets nothing from that expert.  The published model drops nothing.
* Which tokens form a group follows the served path: a prefill's tokens,
  row-major, cut into ``group_count`` equal groups; each decode step's tokens
  (one per row) one group.
* Routing is a step function of the router logits: where a served run's
  rounding moves a near tie, every later slot of its group can move.  A
  served batch's check can therefore follow the routing the run took
  (``Routing`` with a tape) and check that routing by itself.
* A served batch is left-padded with a pad token that every later position
  attends to, as the engine pads it.

Weights are the benchmark's own tensors, read by their keys (the layout the
benchmark draws them in: leaves stacked over layers).  Every product goes
through ``Precision.mm`` so that the control can compute the same function in
a lower precision.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

GROUP_SIZE = 2048


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fake_bf16(x: torch.Tensor) -> torch.Tensor:
    q = x.detach().to(torch.bfloat16).to(torch.float32)
    return x + (q - x).detach() if x.requires_grad else q


def _fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude onto e4m3's 448), back in float32; the gradient passes straight
    through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach() if x.requires_grad else q


class Precision:
    """``"float32"``: every product in f32.  ``"float8"``: every product's two
    operands rounded to float8 e4m3 first (per-tensor scale), the sums in f32:
    the control one precision below the configuration's bfloat16.
    ``"bfloat16"``: the operands rounded to bfloat16, a witness of what the
    configuration's own precision reads."""

    ROUND = {"float32": None, "float8": _fake_fp8, "bfloat16": _fake_bf16}

    def __init__(self, name: str = "float32"):
        if name not in self.ROUND:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self._round = self.ROUND[name]

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return self._round(x) if self._round else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))


def head_dim(cfg: dict) -> int:
    return int(cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"])


def layer(params: dict, i: int) -> dict:
    """Views of layer i of the stacked block leaves."""
    def pick(tree):
        return {k: pick(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]
    return pick(params["blocks"])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, heads, D] rotated by position, the first half of D paired
    with the second."""
    D = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, cfg: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Causal grouped-query self-attention of x [B, S, d] at positions
    0..S-1, within the sliding window; one row at a time."""
    B, S, _ = x.shape
    H, K, D = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    pos = torch.arange(S, device=x.device)
    q = rope(prec.mm(x, p["wq"]["w"]).view(B, S, H, D), pos, cfg["rope_theta"])
    k = rope(prec.mm(x, p["wk"]["w"]).view(B, S, K, D), pos, cfg["rope_theta"])
    v = prec.mm(x, p["wv"]["w"]).view(B, S, K, D)
    allowed = pos[None, :] <= pos[:, None]
    if cfg.get("sliding_window"):
        allowed &= (pos[:, None] - pos[None, :]) < cfg["sliding_window"]
    rows = []
    for b in range(B):
        qg = q[b].view(S, K, H // K, D)
        scores = prec.einsum("skgd,tkd->kgst", qg, k[b]) / D ** 0.5
        probs = torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)
        rows.append(prec.einsum("kgst,tkd->skgd", probs, v[b]).reshape(S, H * D))
    return prec.mm(torch.stack(rows), p["wo"]["w"])


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def group_count(n_tokens: int, group_size: int = GROUP_SIZE) -> int:
    """How many equal groups n tokens are cut into: the most, at most one per
    ``group_size`` tokens, that divides n."""
    groups = max(1, n_tokens // group_size)
    while n_tokens % groups:
        groups -= 1
    return groups


def capacity(tokens: int, moe: dict) -> int:
    c = int(tokens * moe["top_k"] * moe["capacity_factor"] / moe["n_experts"])
    c = max(c, 1)
    return max(((c + 7) // 8) * 8, 8)


def placed(choice: torch.Tensor, n_experts: int, cap: int) -> torch.Tensor:
    """choice [T, k] expert ids of one group -> [T, k] bool: whether each
    choice got a slot.  Slots fill choice 0 of every token in order, then
    choice 1, and so on; an expert takes at most ``cap``."""
    T, k = choice.shape
    counts = torch.zeros(n_experts, dtype=torch.long, device=choice.device)
    keep = torch.zeros(T, k, dtype=torch.bool, device=choice.device)
    for j in range(k):
        onehot = F.one_hot(choice[:, j], n_experts)
        slot = (counts + torch.cumsum(onehot, 0) - onehot).gather(1, choice[:, j:j + 1])[:, 0]
        keep[:, j] = slot < cap
        counts = counts + onehot.sum(0)
    return keep


class Routing:
    """Which tokens route together, and optionally whose routing to follow.

    ``groups``: index tensors into the flat tokens, one a group.  ``tape``:
    a list, one entry a layer, of (choice [N, k] expert ids, placed [N, E]
    bool), the routing a served run took; the experts then take those
    choices and slots instead of working them out, and each layer's check
    is kept: ``margins`` (the widest gap by which a chosen expert's router
    logit here lies below this side's k-th best), ``off_choices`` of
    ``n_choices`` (the choices of the tokens that ``counted`` marks, a flat
    bool mask, all where None, that are not among this side's own top k) and
    ``mismatches`` (slots that the capacity rule, applied to the tape's
    choices, gives otherwise).
    Without a tape each layer's own (choice, placed) goes to ``record``."""

    def __init__(self, groups: list, tape: list | None = None, counted=None):
        self.groups, self.tape, self.counted = groups, tape, counted
        self.record, self.margins, self.mismatches = [], [], 0
        self.off_choices = self.n_choices = 0

    def route(self, logits: torch.Tensor, moe_cfg: dict):
        """(choice [N, k], keep [N, k] bool) for router logits [N, E]."""
        E, k = moe_cfg["n_experts"], moe_cfg["top_k"]
        if self.tape is None:
            choice = torch.topk(logits, k, dim=-1).indices
            keep = torch.zeros_like(choice, dtype=torch.bool)
            for idx in self.groups:
                keep[idx] = placed(choice[idx], E, capacity(len(idx), moe_cfg))
            slots = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
            self.record.append((choice, slots.scatter_(1, choice, keep)))
            return choice, keep
        choice, slots = (t.to(logits.device) for t in self.tape[len(self.margins)])
        choice = choice.long()
        keep = slots.gather(1, choice)
        top = torch.topk(logits, k, dim=-1)
        self.margins.append(float((top.values[:, -1] - logits.gather(1, choice).amin(-1)).max()))
        off = (choice[:, :, None] != top.indices[:, None, :]).all(-1)
        if self.counted is not None:
            off = off[self.counted]
        self.off_choices += int(off.sum())
        self.n_choices += off.numel()
        for idx in self.groups:
            rule = placed(choice[idx], E, capacity(len(idx), moe_cfg))
            self.mismatches += int((rule != keep[idx]).sum())
        return choice, keep


def moe(p: dict, cfg: dict, x: torch.Tensor, routing: Routing, prec: Precision) -> torch.Tensor:
    """The mixture of experts over x [N, d] (N tokens, flat), routed within
    each of ``routing``'s groups; each token's chosen experts weighted by the
    softmax of their router logits."""
    m = cfg["moe"]
    logits = prec.mm(x, p["router"]["w"])                      # [N, E]
    choice, keep = routing.route(logits, m)                   # [N, k]
    gates = torch.softmax(logits.gather(1, choice), dim=-1)
    out = torch.zeros_like(x)
    w = p["experts"]
    for e in range(m["n_experts"]):
        hit = (choice == e) & keep                             # [N, k]
        tokens = hit.any(-1).nonzero()[:, 0]
        if len(tokens) == 0:
            continue
        gate = (gates * hit).sum(-1)[tokens]
        y = swiglu(x[tokens], w["gate"][e], w["up"][e], w["down"][e], prec)
        out = out.index_add(0, tokens, gate[:, None] * y)
    return out


def block(p: dict, cfg: dict, x: torch.Tensor, routing, prec: Precision) -> torch.Tensor:
    eps = cfg["norm_eps"]
    x = x + attention(p["attn"], cfg, rms_norm(x, p["attn_norm"]["scale"], eps), prec)
    h = rms_norm(x, p["mlp_norm"]["scale"], eps)
    if "moe" in p:
        B, S, d = h.shape
        return x + moe(p["moe"], cfg, h.reshape(B * S, d), routing, prec).view(B, S, d)
    mlp = p["mlp"]
    return x + swiglu(h, mlp["gate"]["w"], mlp["up"]["w"], mlp["down"]["w"], prec)


def hidden(params: dict, cfg: dict, tokens: torch.Tensor, prec: Precision,
           routing: Routing | None = None) -> torch.Tensor:
    """The last block's output [B, S, d] for tokens [B, S]."""
    x = params["embed"]["table"][tokens]
    for i in range(cfg["n_layers"]):
        if torch.is_grad_enabled():
            # the backward recomputes each block, so that one row's graph of
            # a whole stack fits beside the weights and the AdamW state
            x = checkpoint(block, layer(params, i), cfg, x, routing, prec, use_reentrant=False)
        else:
            x = block(layer(params, i), cfg, x, routing, prec)
    return x


def logits(params: dict, cfg: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(rms_norm(x, params["final_norm"]["scale"], cfg["norm_eps"]),
                   params["lm_head"]["w"])
