"""Model FLOPs of a latent-attention mixture-of-experts model (DeepSeek-V3's
block) from its configuration's shapes, by ``flops.py``'s conventions: 2 FLOPs
a multiply-add, attention's QK^T and PV over the causal pairs, padding and
remat's recomputation not counted, training three times the forward.

Per token and layer, forward: latent attention's projections (q, the latent
down-projection with the shared rotary key, its up-projection to every
head's k_nope and v, the output); the leading dense layers' SwiGLU; an MoE
layer's router over all its outputs, its shared experts, and the routed
experts this chip holds: ``top_k`` experts a token, of which the share held
(``n_experts`` of ``router_experts``) runs here.  The output head over the
vocabulary's slice at every position.
"""

from __future__ import annotations

from portbench.harness.flops import causal_pairs


def attention_flops_per_token(cfg: dict) -> float:
    """Latent attention's projections for one token, forward."""
    d, H, r = cfg["d_model"], cfg["n_heads"], cfg["kv_lora_rank"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return 2.0 * (d * H * (nope + rope) + d * (r + rope) + r * H * (nope + dv) + H * dv * d)


def pair_flops(cfg: dict) -> float:
    """QK^T (nope + rope wide) and PV (v wide) for one query-key pair in one layer."""
    return 2.0 * cfg["n_heads"] * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                                   + cfg["v_head_dim"])


def moe_flops_per_token(cfg: dict) -> float:
    """One MoE layer for one token, forward: router, shared and held routed experts."""
    d, m = cfg["d_model"], cfg["moe"]
    router = m.get("router_experts") or m["n_experts"]
    routed = m["top_k"] * m["n_experts"] / router
    return 2.0 * (d * router + 3 * d * m["d_ff"] * (m.get("n_shared_experts", 0) + routed))


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """One training step over ``batch`` rows of ``seq`` tokens, logits at every
    position: forward, and the backward as twice the forward."""
    L, n_dense = cfg["n_layers"], cfg.get("first_dense_layers", 0)
    per_token = (L * attention_flops_per_token(cfg)
                 + n_dense * 2.0 * 3 * cfg["d_model"] * cfg["dense_d_ff"]
                 + (L - n_dense) * moe_flops_per_token(cfg)
                 + 2.0 * cfg["d_model"] * cfg["vocab_size"])
    fwd = batch * (seq * per_token + L * pair_flops(cfg) * causal_pairs(seq, None))
    return 3.0 * fwd
