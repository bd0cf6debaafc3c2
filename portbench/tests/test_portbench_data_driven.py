"""A later change adds a cell, a configuration, a traffic mix and a metric as
new files and new BENCHMARK.json entries; the harness finds them by name,
and no file that was there is edited."""

import hashlib
import json
import shutil
from pathlib import Path

from portbench.harness import bench

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()}


def test_a_new_cell_and_metric_are_found_without_editing_a_file(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "internlm2-1.8b.json").read_text())
    (pb / "configs" / "dummy-config.json").write_text(json.dumps(dict(cfg, name="dummy-config")))
    mix = json.loads((pb / "traffic" / "chat-closed-32.json").read_text())
    (pb / "traffic" / "dummy-mix.json").write_text(json.dumps(dict(mix, new_tokens=8)))
    (pb / "cells" / "dummy-cell.json").write_text(json.dumps(
        {"driver": "serve_closed_loop", "route": "flash", "max_batch": 32,
         "limits": {"served_gap": 1.0}}))
    (pb / "metrics" / "dummy_metric.serve.py").write_text(
        "def read(run):\n    return run.get('tokens')\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "dummy-config", "source": "https://example.org/dummy",
                         "file": "portbench/configs/dummy-config.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                           "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "dummy_metric.serve", "unit": "tokens", "better": "higher",
                           "source": "program_counter", "layer": "serve engine (serve/engine.py)",
                           "moves": "serve_tokens_per_s", "workloads": ["dummy-cell"]})
    b["end_to_end"][1].setdefault("workloads", []).append("dummy-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    assert "dummy-cell" in bench.workloads(root)
    cell = bench.load_cell("dummy-cell", root)
    assert cell.config["name"] == "dummy-config" and cell.traffic["new_tokens"] == 8
    assert cell.per_layer == ["dummy_metric.serve"]
    assert "serve_tokens_per_s" in cell.end_to_end and "setup_s" in cell.end_to_end
    assert bench.driver(cell).__name__.endswith("serve_closed_loop")
    assert bench.read_metrics(cell.per_layer, {"tokens": 5}, root) == \
        {"dummy_metric.serve": {"value": 5.0, "unit": "tokens"}}
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


def test_every_named_file_exists():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in b["workloads"]:
        cell = bench.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer and "setup_s" in cell.end_to_end
        for m in cell.end_to_end + cell.per_layer:
            assert callable(bench.reader(m))
        assert (ROOT / "portbench" / "traffic" / f"{cell.traffic['kind']}.py").exists()
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
