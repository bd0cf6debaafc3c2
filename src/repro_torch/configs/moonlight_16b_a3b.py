"""moonlight-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B (``deepseek_v3``).

27L d_model=2048 16H with multi-head latent attention (kv_lora_rank 512, no
q compression, q/k 128 + 64 rotary wide, v 128); layer 0 a dense SwiGLU of
11264, layers 1-26 MoE: 64 routed experts of 1408, top-6 by sigmoid scores
with a correction bias (``noaux_tc``, one group), the chosen scores
normalised and scaled by 2.446, and 2 shared experts; RMSNorm eps 1e-5, RoPE
theta 5e4, vocab 163840, untied head.  Trained dropless, with DeepSeek-V3's
sequence-wise balance loss (alpha 1e-4) and bias update (gamma 1e-3, §4.2).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    rope_theta=50_000.0,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    mlp_type="swiglu",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_dense_layers=1,
    dense_d_ff=11264,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared_experts=2,
                  score_func="sigmoid", routed_scale=2.446,
                  dispatch="dropless", balance_alpha=1e-4, bias_update=1e-3),
)

# a dense layer, then MoE layers that hold 4 of the router's 8 experts
SMOKE = CONFIG.replace(
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    dense_d_ff=128,
    moe=MoEConfig(n_experts=4, router_experts=8, top_k=3, d_ff=32, n_shared_experts=2,
                  score_func="sigmoid", routed_scale=2.446,
                  dispatch="dropless", balance_alpha=1e-4, bias_update=1e-3),
    remat_policy="none",
)
