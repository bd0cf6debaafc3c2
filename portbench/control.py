"""Reads the numbers that the limits of ``correct`` are set from, on the chip
and at the cell's own size; the benchmark's runs do not run it.

    python3 portbench/control.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 --seconds 5 [--out readings.jsonl]

For every seed it runs the cell once (set-up, a short window at the cell's own
load, the check) in this one process and prints the program's numbers; for
the control seeds it also prints the control's: the reference computed one
precision below the configuration's (float8 products for bfloat16), put in
the program's place.  A training cell also reads the fault "half of the batch
left out, the mean taken over the rest", planted in the reference put in the
program's place.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import bench

    device = "cuda" if torch.cuda.is_available() else "cpu"
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = bench.load_cell(args.workload, ROOT)
        t0 = time.perf_counter()
        out = bench.run(cell, seed, args.seconds, False, device, t0, control=seed in control)
        line = {"workload": args.workload, "seed": seed, "correct": out["correct"],
                "checks": out["checks"], "readings": out.get("readings", {}),
                "metrics": out["metrics"], "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del out
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
