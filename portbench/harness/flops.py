"""Model FLOPs from a configuration's shapes, the same whatever implements
the step.

Every matrix product the architecture needs counts 2 FLOPs a multiply-add:
the attention projections, the FFN (for a mixture of experts the router and
the top-k experts only), the output head over the positions whose logits the
path needs, and attention's QK^T and PV over the causal pairs within the
window.  Padding and recomputation (remat) are not counted; training counts
the forward three times.
"""

from __future__ import annotations


def _head_dim(cfg: dict) -> int:
    return int(cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"])


def layer_flops_per_token(cfg: dict) -> float:
    """One layer's projections and FFN for one token, forward."""
    d, H, K, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], _head_dim(cfg)
    attn = 2 * d * (H + 2 * K) * hd + 2 * H * hd * d
    moe = cfg.get("moe")
    if moe:
        ffn = moe["top_k"] * 2 * 3 * d * moe["d_ff"] + 2 * d * moe["n_experts"]
    elif cfg.get("mlp_type", "swiglu") == "swiglu":
        ffn = 2 * 3 * d * cfg["d_ff"]
    else:
        ffn = 2 * 2 * d * cfg["d_ff"]
    return float(attn + ffn)


def pair_flops(cfg: dict) -> float:
    """QK^T and PV for one query-key pair in one layer."""
    return 4.0 * cfg["n_heads"] * _head_dim(cfg)


def head_flops(cfg: dict) -> float:
    """The output head for one position."""
    return 2.0 * cfg["d_model"] * cfg["vocab_size"]


def causal_pairs(n: int, window: int | None) -> int:
    """Query-key pairs of a causal sequence of n tokens within the window."""
    if window is None or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """One training step over ``batch`` rows of ``seq`` tokens, logits at
    every position: forward, and the backward as twice the forward."""
    L, w = cfg["n_layers"], cfg.get("sliding_window")
    fwd = batch * (seq * L * layer_flops_per_token(cfg)
                   + L * pair_flops(cfg) * causal_pairs(seq, w)
                   + seq * head_flops(cfg))
    return 3.0 * fwd


def request_flops(cfg: dict, prompt_len: int, new_tokens: int) -> float:
    """One served request: the prefill of its own ``prompt_len`` tokens (logits
    at the last), then ``new_tokens - 1`` decode steps, the j-th at position
    prompt_len + j - 1 attending to the request's own prompt_len + j tokens."""
    L, w = cfg["n_layers"], cfg.get("sliding_window")
    per_tok = L * layer_flops_per_token(cfg)
    total = prompt_len * per_tok + L * pair_flops(cfg) * causal_pairs(prompt_len, w) \
        + head_flops(cfg)
    for j in range(1, new_tokens):
        keys = prompt_len + j
        total += per_tok + L * pair_flops(cfg) * (min(keys, w) if w else keys) + head_flops(cfg)
    return float(total)
