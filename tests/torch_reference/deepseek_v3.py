"""A plain float32 DeepSeek-V3 language model (Moonlight-16B-A3B's block), for
the port's CPU tests: the forward, the loss with the sequence-wise balance
term, and the correction bias's update rule.

Written from arXiv:2412.19437 (§2.1.1 latent attention, §2.1.2 the MoE with
auxiliary-loss-free balancing and eqs. 17-20, §4.2 the hyper-parameters) and
the released ``config.json``: RMSNorm before attention and before the FFN;
latent attention without q compression (q per head as [q_nope; q_pe],
[c_kv; k_pe] from one down-projection, c_kv through its own RMSNorm, [k_nope;
v] per head from c_kv, one k_pe shared by the heads, softmax scale
1/sqrt(nope + rope)); the first ``first_dense_layers`` blocks a SwiGLU, the
rest a mixture: sigmoid scores, the top k of score + bias, gates the chosen
scores over their sum times ``routed_scale``, plus shared experts as one
SwiGLU; a final RMSNorm and an untied head.  Each expert runs on every token
and is weighted by its gate (zero where not chosen): no dispatch at all.

Departures, each the port's semantics, which the tests hold it to:

* RoPE rotates the first half of a head's rotary part with the second (the
  split-half layout); the released code de-interleaves q_pe and k_pe first,
  which on drawn weights is a fixed permutation of W's columns;
* the layer may hold a share of the router's experts (expert parallelism):
  it routes over all of them and adds only its own experts' part;
* the balance loss's alpha is 1e-4 and the bias's step gamma 1e-3
  (DeepSeek-V3 §4.2; the released config gives neither); each MoE layer's
  balance loss is summed into the loss.

Weights are read by the port's keys (``blocks`` stacked over the MoE layers,
``dense_blocks`` over the leading dense ones, a dense weight [d_in, d_out]);
``cfg`` is the configuration as a dict (``dataclasses.asdict``).  Imports
nothing of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x [B, S, heads, D] at positions 0..S-1, the first half of D paired with
    the second."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32) / D)
    ang = torch.arange(S, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def mla(p, cfg, x):
    B, S, _ = x.shape
    H, r = cfg["n_heads"], cfg["kv_lora_rank"]
    nope, rp, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = (x @ p["wq"]["w"]).view(B, S, H, nope + rp)
    a = x @ p["wkv_a"]["w"]
    c_kv = rms_norm(a[..., :r], p["kv_norm"]["scale"], cfg["norm_eps"])
    k_pe = rope(a[..., r:].view(B, S, 1, rp), cfg["rope_theta"]).expand(B, S, H, rp)
    kv = (c_kv @ p["wkv_b"]["w"]).view(B, S, H, nope + dv)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cfg["rope_theta"])], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    v = kv[..., nope:]
    scores = torch.einsum("bshd,bthd->bhst", q, k) / (nope + rp) ** 0.5
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, H * dv)
    return out @ p["wo"]["w"]


def moe(p, cfg, x, bias):
    """x [B, S, d] -> (the shared experts plus the held experts' gated
    outputs, the sequence-wise balance loss before alpha, each router
    output's count of choices [E])."""
    m = cfg["moe"]
    B, S, d = x.shape
    E, k = m["router_experts"] or m["n_experts"], m["top_k"]
    lo, held = m["first_expert"], m["n_experts"]
    s = torch.sigmoid(x @ p["router"]["w"])                  # [B, S, E]
    choice = torch.topk(s + bias, k, dim=-1).indices         # [B, S, k]
    chosen = torch.zeros_like(s).scatter(-1, choice, 1.0)    # [B, S, E] 0/1
    w = s * chosen
    w = w / w.sum(-1, keepdim=True) * m["routed_scale"]
    out = swiglu(x, p["shared"]["gate"]["w"], p["shared"]["up"]["w"], p["shared"]["down"]["w"])
    ex = p["experts"]
    for e in range(held):
        out = out + w[..., lo + e, None] * swiglu(x, ex["gate"][e], ex["up"][e], ex["down"][e])
    f = chosen.sum(1) * E / (k * S)                          # [B, E]
    P = (s / s.sum(-1, keepdim=True)).mean(1)
    return out, (f * P).sum(-1).mean(), chosen.sum((0, 1))


def block(p, cfg, x, bias=None):
    """(x after the block, its balance loss, its counts); a dense block gives
    0 and None."""
    eps = cfg["norm_eps"]
    x = x + mla(p["attn"], cfg, rms_norm(x, p["attn_norm"]["scale"], eps))
    h = rms_norm(x, p["mlp_norm"]["scale"], eps)
    if "moe" in p:
        out, bal, counts = moe(p["moe"], cfg, h, bias)
        return x + out, bal, counts
    m = p["mlp"]
    return x + swiglu(h, m["gate"]["w"], m["up"]["w"], m["down"]["w"]), 0.0, None


def _layer(stacked, i):
    if isinstance(stacked, dict):
        return {key: _layer(v, i) for key, v in stacked.items()}
    return stacked[i]


def forward(params, cfg, tokens, bias):
    """(logits [B, S, V], summed balance loss before alpha, counts [L_moe, E])
    for tokens [B, S] and the routers' biases [L_moe, E]."""
    x = params["embed"]["table"][tokens]
    n_dense = cfg["first_dense_layers"]
    for i in range(n_dense):
        x, _, _ = block(_layer(params["dense_blocks"], i), cfg, x)
    balance, counts = 0.0, []
    for i in range(cfg["n_layers"] - n_dense):
        x, bal, c = block(_layer(params["blocks"], i), cfg, x, bias[i])
        balance, counts = balance + bal, counts + [c]
    x = rms_norm(x, params["final_norm"]["scale"], cfg["norm_eps"])
    return x @ params["lm_head"]["w"], balance, torch.stack(counts)


def loss(params, cfg, tokens, labels, bias):
    """(mean next-token cross-entropy + alpha * the summed balance loss,
    counts [L_moe, E])."""
    logits, balance, counts = forward(params, cfg, tokens, bias)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return ce + cfg["moe"]["balance_alpha"] * balance, counts


def update_bias(bias, counts, gamma):
    """b_i += gamma * sign(mean load - load_i), a layer a row."""
    load = counts.float()
    return bias + gamma * torch.sign(load.mean(-1, keepdim=True) - load)
