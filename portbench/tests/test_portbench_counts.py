"""Model FLOPs and the flash bound against hand counts at SMOKE sizes."""

import pytest

from portbench.harness import bounds, flops

DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256, mlp_type="swiglu")
MOE = dict(DENSE, sliding_window=4, moe={"n_experts": 4, "top_k": 2, "d_ff": 32})


def test_layer_flops_by_hand():
    # q 64x64, k and v 64x32 each, o 64x64: 2 * 64 * 192 ; swiglu 3 * 64 * 128
    assert flops.layer_flops_per_token(DENSE) == 2 * 64 * 192 + 2 * 3 * 64 * 128
    # top-2 of experts 32 wide, and the router's 64 x 4
    assert flops.layer_flops_per_token(MOE) == 2 * 64 * 192 + 2 * 2 * 3 * 64 * 32 + 2 * 64 * 4


def test_causal_pairs_within_a_window():
    assert flops.causal_pairs(5, None) == 15
    # window 2: pairs (0,0) (1,0) (1,1) (2,1) (2,2) ...: 1 + 2 + 2 + 2 + 2
    assert flops.causal_pairs(5, 2) == 9
    assert bounds.unmasked_pairs(5, 5, True, 2) == 9
    assert bounds.unmasked_pairs(5, 5, True, None) == 15
    assert bounds.unmasked_pairs(3, 4, False, None) == 12


def test_train_step_flops_by_hand():
    B, S = 2, 8
    per_tok = 2 * 64 * 192 + 2 * 3 * 64 * 128
    attn = 4 * 4 * 16 * (S * (S + 1) // 2)
    head = 2 * 64 * 256
    fwd = B * (S * 2 * per_tok + 2 * attn + S * head)
    assert flops.train_step_flops(DENSE, B, S) == 3 * fwd


def test_request_flops_by_hand():
    # prompt of 3, 3 new tokens: prefill 3 tokens (6 pairs), logits once; then
    # two decode steps attending to 4 and 5 keys (window 4: 4 and 4)
    per_tok = 2 * flops.layer_flops_per_token(MOE)
    pair = 2 * 4 * 4 * 16
    head = 2 * 64 * 256
    want = 3 * per_tok + pair * 6 + head + (per_tok + pair * 4 + head) * 2
    assert flops.request_flops(MOE, 3, 3) == want


def test_flash_bound_by_hand():
    # B 1, S T 4, H 2, K 1, D 16, bf16 causal: bytes 2 * (2*4*2*16 + 2*4*1*16),
    # operations 4 * 2 * 16 * 10 pairs
    t, which = bounds.attention_bound_s("bfloat16", 1, 4, 4, 2, 1, 16, True, None)
    assert which == "bytes"
    assert t == pytest.approx(2 * (256 + 128) / 3.35e12)
    t, which = bounds.attention_bound_s("bfloat16", 32, 932, 932, 32, 8, 128, True, 4096)
    assert which == "operations"
    assert t == pytest.approx(4 * 32 * 32 * 128 * (932 * 933 // 2) / 989e12)
