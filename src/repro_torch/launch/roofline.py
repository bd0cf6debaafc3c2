"""Roofline analysis over dry-run records: counterpart of
``repro/launch/roofline.py``.

Three terms per (arch x shape x mesh), all in seconds a step, on one H100
(:mod:`repro_torch.launch.mesh`'s published peaks):

    compute    = FLOPs_per_device / PEAK_FLOPS_BF16            (989e12 FLOP/s)
    memory     = bytes_accessed_per_device / HBM_BANDWIDTH     (3.35e12 B/s)
    collective = wire_bytes_per_device / INTER_NODE_BANDWIDTH  (50e9 B/s)

plus MODEL_FLOPS (6·N·D train, 2·N·D prefill, 2·N·B decode; N the active
parameters for MoE), the useful-compute ratio MODEL_FLOPS / (chips ·
FLOPs_per_device), and the roofline fraction ideal_time / max(term), where
ideal_time = MODEL_FLOPS / (chips · peak).

Caveat recorded with the table: bytes accessed sums every local op's inputs
and outputs (:func:`repro_torch.launch.hlo.cost_analysis_dict`), as eager
PyTorch runs them, unfused; a fused program moves fewer, so the memory term
is an upper bound and compares across cells, not against a measured time.
"""

from __future__ import annotations

import glob
import json
import os

from repro_torch.launch.mesh import HBM_BANDWIDTH, INTER_NODE_BANDWIDTH, PEAK_FLOPS_BF16

RESULTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "build", "dryrun",
)


def model_flops(record: dict) -> float:
    n_active = record["params_active"]
    if record["kind"] == "train":
        return 6.0 * n_active * record["global_batch"] * record["seq_len"]
    if record["kind"] == "prefill":
        return 2.0 * n_active * record["global_batch"] * record["seq_len"]
    # decode: one token per sequence
    return 2.0 * n_active * record["global_batch"]


def analyze(record: dict) -> dict:
    chips = record["chips"]
    flops_dev = record.get("cost", {}).get("flops", 0.0)
    bytes_dev = record.get("cost", {}).get("bytes accessed", 0.0)
    wire_dev = record.get("collectives", {}).get("_total", {}).get("wire_bytes_per_device", 0)
    compute_t = flops_dev / PEAK_FLOPS_BF16
    memory_t = bytes_dev / HBM_BANDWIDTH
    coll_t = wire_dev / INTER_NODE_BANDWIDTH
    mf = model_flops(record)
    ideal_t = mf / (chips * PEAK_FLOPS_BF16)
    terms = {"compute": compute_t, "memory": memory_t, "collective": coll_t}
    dominant = max(terms, key=terms.get)
    bound_t = max(terms.values()) if max(terms.values()) > 0 else float("inf")
    useful = mf / (flops_dev * chips) if flops_dev else 0.0
    suggestion = {
        "compute": "reduce recompute (remat policy) / shrink useless FLOPs "
                   "(ratio below 1 means padding or recompute waste)",
        "memory": "fuse elementwise chains / microbatch to shrink live activations /"
                  " lower-precision activations",
        "collective": "reshard to turn all-reduce(+slice) into reduce-scatter, "
                      "compress gradients to bf16, overlap collectives with compute",
    }[dominant]
    return {
        "arch": record["arch"],
        "shape": record["shape"],
        "mesh": record["mesh"],
        "chips": chips,
        "kind": record["kind"],
        "status": record.get("status"),
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": coll_t,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": flops_dev * chips,
        "useful_ratio": useful,
        "ideal_s": ideal_t,
        "flops_dev": flops_dev,
        "trace_s": record.get("lower_seconds"),
        "roofline_fraction": (ideal_t / bound_t) if bound_t else 0.0,
        "temp_bytes_dev": record.get("memory", {}).get("temp_size_in_bytes"),
        "arg_bytes_dev": record.get("memory", {}).get("argument_size_in_bytes"),
        "collective_counts": {
            k: v.get("count")
            for k, v in record.get("collectives", {}).items()
            if not k.startswith("_")
        },
        "suggestion": suggestion,
        "tag": record.get("tag", ""),
    }


def load_records(mesh: str | None = None, tag: str | None = "") -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(RESULTS_DIR, "*.json"))):
        with open(path) as fh:
            rec = json.load(fh)
        if mesh and rec.get("mesh") != mesh:
            continue
        if tag is not None and rec.get("tag", "") != tag:
            continue
        out.append(rec)
    return out


def markdown_table(rows: list[dict]) -> str:
    header = (
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "dominant | useful | roofline frac | FLOPs/card | trace s |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                         f"ERROR | — | — | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} "
            f"| {r['collective_s']:.3f} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {r['flops_dev']:.3e} | {r['trace_s']:.1f} |"
        )
    return header + "\n".join(lines) + "\n"


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--mesh", default="single")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)
    rows = []
    for rec in load_records(mesh=args.mesh):
        rows.append(analyze(rec) if rec.get("status") == "ok" else
                    {k: rec.get(k) for k in ("arch", "shape", "mesh", "status")})
    if args.json:
        print(json.dumps(rows, indent=1))
    else:
        print(markdown_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
