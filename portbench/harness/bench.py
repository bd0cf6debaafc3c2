"""Finding a cell by name and running it once.

Everything that belongs to one configuration, traffic mix, cell or metric is
a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``portbench/configs/<config>.json``: the model's sizes as run, with its
  source, ``reduced``, ``assumed`` and the deployment it stands for;
* ``portbench/traffic/<traffic>.json``: a mix's parameters, read by the
  generator ``portbench/traffic/<kind>.py`` its ``"kind"`` names;
* ``portbench/cells/<cell>.json``: the driver (``portbench/drivers/<driver>.py``),
  the route and run settings, and the limits of the numbers compared;
* ``portbench/metrics/<metric>.py``: a reader, ``read(run) -> float | None``,
  of the run's record.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    spec: dict           # portbench/cells/<name>.json
    config: dict         # portbench/configs/<config>.json
    traffic: dict        # portbench/traffic/<traffic>.json
    end_to_end: list     # metric names this cell reports with --trace 0
    per_layer: list      # ... and with --trace 1
    root: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def workloads(root: Path = ROOT) -> list[str]:
    return [w["name"] for w in _read(root / "BENCHMARK.json")["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {[w['name'] for w in bench['workloads']]}")
    pb = root / "portbench"
    return Cell(
        name=name, entry=entry, spec=_read(pb / "cells" / f"{name}.json"),
        config=_read(pb / "configs" / f"{entry['config']}.json"),
        traffic=_read(pb / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m["name"] for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m["name"] for m in bench["per_layer"] if _applies(m, name)],
        root=root)


def metric_units(root: Path = ROOT) -> dict[str, str]:
    bench = _read(root / "BENCHMARK.json")
    return {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}


def reader(metric: str, root: Path = ROOT):
    """``read`` of ``portbench/metrics/<metric>.py``, loaded by its path (a
    metric's name may hold dots)."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def traffic_generator(cell: Cell, vocab_size: int, seed: int):
    module = importlib.import_module(f"portbench.traffic.{cell.traffic['kind']}")
    return module.make(cell.traffic, vocab_size, seed)


def driver(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.spec['driver']}")


def model_config(cfg: dict, route: str | None = None):
    """The port's ``ModelConfig`` of a configuration file: its keys that name
    a field of ``ModelConfig`` (``moe`` as a ``MoEConfig``), the cell's route as
    ``attention_impl``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    if kw.get("moe") is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    if route is not None:
        kw["attention_impl"] = route
    return ModelConfig(**kw)


def read_metrics(names: list, run: dict, root: Path = ROOT) -> dict:
    """Each metric a reader finds something to read for, with its unit; a
    metric whose reader returns None is left out."""
    units = metric_units(root)
    out = {}
    for name in names:
        value = reader(name, root)(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": units[name]}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a number
    that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
        control: bool = False) -> dict:
    """One run of ``cell``: its driver's set-up, window and check, then the
    metrics (end-to-end ones, or with ``trace`` per-layer ones) read from the
    run's record.  The result's keys are those of the benchmark's last line,
    with ``checks`` last.  ``control`` (``control.py``, not the benchmark's
    runs) also reads the control's numbers, and a training cell's fault,
    under ``readings``."""
    if device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()
    out = driver(cell).run(cell, seed, seconds, trace, device, t0, control)
    rec = out["record"]
    names = cell.per_layer if trace else cell.end_to_end
    result = {
        "correct": bool(out["correct"]),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": read_metrics(names, rec, cell.root),
        "device": {"platform": "gpu" if device == "cuda" else device, "kind": device,
                   "count": cell.chips, "memory_peak_bytes": int(out["memory_peak_bytes"])},
    }
    if trace and rec.get("trace"):
        t = rec["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    if out.get("readings"):
        result["readings"] = out["readings"]
    result["checks"] = out["checks"]
    print(f"portbench: the window's units took (s): {rec['unit_s']}", file=sys.stderr)
    return result
