"""Runs one benchmark cell once and prints its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It measures the PyTorch/CUDA port
(``src/repro_torch``) on the CUDA devices of this machine: set-up (weights
drawn from the seed on the device, the kernels loaded, one warm-up at the
cell's own shapes), a window of ``--seconds``, then the check of what the
window produced against the plain float32 reference.  ``--trace 1`` reports
the cell's per-layer metrics instead of its end-to-end ones.  Without enough
CUDA devices it prints no result and exits 3; it exits 4, with no result, if
JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Import paths, and every cache of the program inside the checkout at a
    fixed place (the CUDA kernels build into ``build/`` there by themselves)."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    cache = ROOT / "build" / "portbench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def _power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    from portbench.harness import bench

    cell = bench.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 3
    out = bench.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    loaded = bench.forbidden_modules(sys.modules)
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 4
    out["device"].update(kind=torch.cuda.get_device_name(0), power_limit_w=_power_limit_w())
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
