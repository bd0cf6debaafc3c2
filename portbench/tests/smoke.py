"""A copy of the benchmark's files at sizes a CPU test can hold: the same
cells, metrics and drivers, with the configurations and mixes shrunk."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMOKE_CONFIGS = {
    "internlm2-1.8b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                           d_ff=128, vocab_size=256),
    "mixtral-8x7b-8l": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                            d_ff=128, vocab_size=256, sliding_window=32,
                            moe={"n_experts": 4, "top_k": 2, "d_ff": 128,
                                 "capacity_factor": 1.25}),
}
SMOKE_TRAFFIC = {
    "train-8x2048": dict(batch=4, seq_len=32),
    "chat-closed-32": dict(clients=4, prompt_median=12, prompt_min=4, prompt_max=24,
                           new_tokens=6),
}

# the limits of ``correct`` at SMOKE sizes, where the program's relative
# gaps are some ten times the full sizes' (few tokens to average over): the
# SMOKE program reads at most 5.8e-4 / 1.8e-3 / 9.1e-4 (loss / gradient /
# change) and 0.0035 / 0.012 / 0.016 / 0.01 (widest gap / logits / routing
# margin / share of real tokens' choices off the reference's top 2), its
# control at least 7.7e-4 / 8.2e-3 / 4.5e-3 and 0.20 / 0.12 / 0.18 / 0.027
# (CPU, four seeds; the routing share six)
SMOKE_LIMITS = {
    "internlm2-train-2k": {"loss_gap": 1.5e-3, "grad_gap": 5e-3, "change_gap": 3e-3},
    "mixtral-serve-decode": {"served_gap": 0.1, "logits_rel_l2": 0.04,
                             "served_not_argmax": 0.0, "route_margin": 0.08,
                             "route_choices_off": 0.02, "slots_off": 0.0},
}


def _patch(path: Path, changes: dict) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data, indent=1))


def smoke_root(tmp: Path, limits: dict | None = None) -> Path:
    """A root under ``tmp`` holding BENCHMARK.json and portbench/ with SMOKE
    sizes and limits (``limits``, {cell: {number: limit}}, instead)."""
    root = tmp / "bench"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, changes in SMOKE_CONFIGS.items():
        _patch(root / "portbench" / "configs" / f"{name}.json", changes)
    for name, changes in SMOKE_TRAFFIC.items():
        _patch(root / "portbench" / "traffic" / f"{name}.json", changes)
    for cell, lim in (limits or SMOKE_LIMITS).items():
        _patch(root / "portbench" / "cells" / f"{cell}.json", {"limits": lim})
    return root
