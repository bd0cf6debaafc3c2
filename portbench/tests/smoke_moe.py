"""``smoke.smoke_root`` with the MoE training cell shrunk too: the same
structure (a dense layer, then MoE layers holding 4 of the router's 8
experts, shared experts, latent attention), at sizes a CPU test can hold."""

from __future__ import annotations

from pathlib import Path

from portbench.tests.smoke import SMOKE_LIMITS, _patch, smoke_root

CELL = "moonlight-train-2k"
CONFIG = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab_size=256,
              kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
              dense_d_ff=128,
              moe={"n_experts": 4, "router_experts": 8, "first_expert": 0, "top_k": 3,
                   "d_ff": 32, "n_shared_experts": 2, "score_func": "sigmoid",
                   "routed_scale": 2.446, "dispatch": "dropless",
                   "balance_alpha": 1e-4, "bias_update": 1e-3})
TRAFFIC = dict(batch=4, seq_len=32)

# the limits of ``correct`` at SMOKE sizes: the SMOKE program reads at most
# 4.5e-4 / 4.7e-3 / 3.0e-3 (loss / gradient / change) and 0.012 / 0.0085
# (routing margin / share of choices off the reference's top k), its control
# at least 1.2e-3 / 3.6e-2 / 6.4e-3 and 0.12 / 0.053, half the batch at least
# 1.9e-2 / 9.4e-2 / 0.16 (CPU, seeds 2**31 + 11..14); the biases exactly
LIMITS = {"loss_gap": 1e-3, "grad_gap": 1.5e-2, "change_gap": 5e-3, "route_margin": 0.05,
          "route_choices_off": 0.03, "bias_off": 0.0}


def moe_smoke_root(tmp: Path, limits: dict | None = None) -> Path:
    root = smoke_root(tmp, dict(SMOKE_LIMITS, **{CELL: limits or LIMITS}))
    pb = root / "portbench"
    _patch(pb / "configs" / "moonlight-16b-a3b-ep8.json", CONFIG)
    _patch(pb / "traffic" / "train-16x2048.json", TRAFFIC)
    return root
