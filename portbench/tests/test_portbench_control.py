"""The control, the reference computed one precision below the
configuration's (float8 products for bfloat16) and put in the program's
place, comes out not correct under the cells' own limits: at SMOKE sizes on
the CPU here, and at the cells' own sizes on the card (marked ``chip``)."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench.harness import bench
from portbench.tests.smoke import smoke_root

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("internlm2-train-2k", "mixtral-serve-decode")
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_smoke_sizes(tmp_path, cell):
    root = smoke_root(tmp_path)
    for seed in SEEDS:
        c = bench.load_cell(cell, root)
        out = bench.run(c, seed, 0.5, False, "cpu", time.perf_counter(), control=True)
        ok, checks = bench.judge(out["readings"]["control"], c.spec["limits"])
        assert not ok, (seed, checks)


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes_on_the_card(cuda_device, cell, tmp_path):
    out = tmp_path / "control.jsonl"
    seeds = ",".join(str(s) for s in SEEDS)
    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "control.py"),
                           "--workload", cell, "--seeds", seeds, "--control-seeds", seeds,
                           "--seconds", "3", "--out", str(out)],
                          cwd=ROOT, capture_output=True, text=True, timeout=3000)
    assert proc.returncode == 0, proc.stderr[-3000:]
    limits = bench.load_cell(cell).spec["limits"]
    for line in out.read_text().splitlines():
        rec = json.loads(line)
        assert rec["correct"], rec["checks"]
        assert not bench.judge(rec["readings"]["control"], limits)[0], rec["readings"]
