"""Nothing the benchmark runs loads JAX or the JAX package ``repro`` (compared
by whole top-level names: ``repro_torch`` is not ``repro``), and the reference
loads nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.harness.bench import forbidden_modules

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping", "reprox"]) == []
    assert forbidden_modules(["repro", "repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_no_file_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        if "tests" in path.relative_to(PB).parts:
            continue
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (PB / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


RUN = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from pathlib import Path
from portbench.tests.smoke import smoke_root
from portbench.harness import bench
root = smoke_root(Path(sys.argv[2]))
before = set(sys.modules)
cell = bench.load_cell(sys.argv[3], root)
out = bench.run(cell, 7, 0.5, False, "cpu", time.perf_counter())
ref = [m for m in sys.modules if m.startswith("portbench.reference")]
print(json.dumps({"correct": out["correct"], "modules": sorted(sys.modules),
                  "reference": ref}))
"""


def test_a_run_loads_no_jax_module(tmp_path):
    for cell in ("internlm2-train-2k", "mixtral-serve-decode"):
        out = subprocess.run([sys.executable, "-c", RUN, str(ROOT), str(tmp_path / cell), cell],
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert forbidden_modules(res["modules"]) == [], cell
        assert "repro_torch" in {m.split(".")[0] for m in res["modules"]}
        assert res["reference"], "the run checked nothing against the reference"
