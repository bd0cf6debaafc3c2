"""Training launcher: the paper's automation services driving the PyTorch
fabric.  Counterpart of ``repro/launch/train.py``.

The end-to-end driver publishes a *training flow* — stage data, train in
bounded segments, evaluate, checkpoint, catalog results — and runs it through
the Flows service of the port's control plane (:mod:`repro_torch.core`).
Fault tolerance is expressed in the flow definition itself: the Train action
``Catch``es ``NodeFailure`` and routes to a Restore state (checkpoint
restore), after which training resumes — the paper's error-routing semantics
applied to an ML job.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --smoke --segments 3 --steps-per-segment 5 --simulate-failure [--device cpu]

It runs on CUDA unless ``--device cpu`` is given, at the reduced (smoke)
config unless ``--full`` is given, unsharded: like the reference's parser it
has no mesh flag (``TrainingFabric(mesh=...)`` takes one, and
:mod:`repro_torch.launch.elastic` runs a sharded flow).  ``main`` shuts its engine down before it
returns, so it can be called from a program that goes on.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.core.actions import ActionRegistry
from repro_torch.core.clock import RealClock
from repro_torch.core.engine import PollingPolicy
from repro_torch.core.flows_service import FlowsService
from repro_torch.core.providers import (
    ComputeProvider,
    EmailProvider,
    SearchProvider,
    TransferProvider,
)
from repro_torch.train.fabric import TrainingFabric


def training_flow_definition(fns: dict, eid: str, n_segments: int) -> dict:
    """The segmented training flow with failure recovery.

    Stage -> [Train -> (NodeFailure? Restore -> Train)] x segments
          -> Evaluate -> Checkpoint -> Catalog -> Notify
    """
    compute = lambda fid, kwargs: {  # noqa: E731
        "Type": "Action",
        "ActionUrl": "ap://compute",
        "Parameters": {
            "endpoint_id": eid,
            "function_id": fid,
            "kwargs": kwargs,
        },
    }
    states = {
        "Stage": {
            "Type": "Pass",
            "Parameters": {"segment": 0},
            "Next": "Train",
        },
        "Train": {
            **compute(fns["train_steps"], {}),
            "ResultPath": "$.train",
            "WaitTime": 3600,
            "Catch": [
                {
                    "ErrorEquals": ["ActionFailedException"],
                    "ResultPath": "$.failure",
                    "Next": "Restore",
                }
            ],
            "Next": "Checkpoint",
        },
        "Restore": {
            **compute(fns["restore_latest"], {}),
            "ResultPath": "$.restore",
            "Next": "Train",
        },
        "Checkpoint": {
            **compute(fns["save_checkpoint"], {}),
            "ResultPath": "$.checkpoint",
            "Next": "NextSegment",
        },
        "NextSegment": {
            "Type": "Pass",
            "Parameters": {"segment.$": "$.segment"},
            "Next": "BumpSegment",
        },
        "BumpSegment": {
            "Type": "Choice",
            "Choices": [
                {
                    "Variable": "$.segment",
                    "NumericLessThan": n_segments - 1,
                    "Next": "Increment",
                }
            ],
            "Default": "Evaluate",
        },
        "Increment": {
            "Type": "Action",
            "ActionUrl": "ap://compute",
            "Parameters": {
                "endpoint_id": eid,
                "function_id": fns["_increment"],
                "kwargs": {"segment.$": "$.segment"},
            },
            "ResultPath": "$.bump",
            "Next": "ApplyIncrement",
        },
        "ApplyIncrement": {
            "Type": "Pass",
            "Parameters": {"segment.$": "$.bump.details.results[0]"},
            "Next": "Train",
        },
        "Evaluate": {
            **compute(fns["evaluate"], {}),
            "ResultPath": "$.eval",
            "Next": "Catalog",
        },
        "Catalog": {
            "Type": "Action",
            "ActionUrl": "ap://search",
            "Parameters": {
                "operation": "ingest",
                "index": "training-runs",
                "subject.$": "$.run_label",
                "entry.$": "$.eval.details",
            },
            "ResultPath": "$.catalog",
            "Next": "Notify",
        },
        "Notify": {
            "Type": "Action",
            "ActionUrl": "ap://email",
            "Parameters": {
                "to": "scientist@lab.example",
                "subject": "Training run ${label} finished",
                "body": "Final eval loss: ${loss}",
                "template_values.$": "$.notify_values",
            },
            "ResultPath": "$.notified",
            "End": True,
        },
    }
    return {"Comment": "Segmented training with failure recovery",
            "StartAt": "Stage", "States": states}


def build_stack(workdir: str, clock=None):
    clock = clock or RealClock()
    registry = ActionRegistry()
    compute = ComputeProvider(clock=clock)
    registry.register(compute)
    registry.register(TransferProvider(clock=clock, workspace=workdir))
    registry.register(SearchProvider(
        clock=clock, persist_dir=os.path.join(workdir, "search")))
    registry.register(EmailProvider(
        clock=clock, outbox_path=os.path.join(workdir, "outbox.mbox")))
    flows = FlowsService(
        registry, clock=clock,
        polling=PollingPolicy(initial_seconds=0.02, cap_seconds=0.5,
                              use_callbacks=True),
    )
    return flows, compute


def run_training_flow(fabric: TrainingFabric, workdir: str, segments: int,
                      steps_per_segment: int, simulate_failure: bool = False,
                      label: str = "train-demo"):
    """Publishes the segmented training flow over ``fabric`` and runs it to its
    end: a seed checkpoint first (so a failure in segment 0 can restore), a
    ``NodeFailure`` injected one step into the second segment (into the first
    when there is one segment) if ``simulate_failure``.  Returns the finished
    run; the engine is shut down."""
    fabric.save_checkpoint()
    if simulate_failure:
        fabric.inject_failure_at = (int(fabric.state.step)
                                    + steps_per_segment * (segments > 1) + 1)

    flows, compute = build_stack(workdir)
    reg = fabric.register_all(compute)
    reg["functions"]["_increment"] = compute.register_function(
        lambda segment: segment + 1, name="increment"
    )
    fabric_fns = dict(reg["functions"])
    # bind per-segment step counts
    compute._functions[fabric_fns["train_steps"]].fn = (
        lambda **kw: fabric.train_steps(n_steps=steps_per_segment)
    )

    definition = training_flow_definition(fabric_fns, reg["endpoint_id"], segments)
    arch = fabric.model_cfg.arch
    record = flows.publish_flow(
        definition,
        input_schema={"type": "object"},
        title=f"Train {arch}",
        keywords=["training", arch],
    )
    run = flows.run_flow(
        record.flow_id,
        {"run_label": label, "notify_values": {"label": label, "loss": "(see catalog)"}},
        label=label,
    )
    flows.engine.wait(run.run_id, timeout=3600)
    flows.engine.shutdown()
    return run


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--arch", default="internlm2-1.8b")
    parser.add_argument("--smoke", action="store_true", default=True)
    parser.add_argument("--full", dest="smoke", action="store_false")
    parser.add_argument("--segments", type=int, default=2)
    parser.add_argument("--steps-per-segment", type=int, default=5)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument("--simulate-failure", action="store_true")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--label", default="train-demo")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="repro-train-")
    cfg = configs.get(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(total_steps=args.segments * args.steps_per_segment,
                       warmup_steps=2, learning_rate=1e-3)
    fabric = TrainingFabric(
        cfg, tcfg, batch=args.batch, seq_len=args.seq_len,
        ckpt_dir=os.path.join(workdir, "ckpt"), device=args.device,
    )
    run = run_training_flow(fabric, workdir, args.segments, args.steps_per_segment,
                            args.simulate_failure, args.label)
    print(f"run {run.run_id}: {run.status}")
    if run.status != "SUCCEEDED":
        print(json.dumps(run.error, indent=1))
        return 1
    print("eval:", json.dumps(run.context.get("eval", {}).get("details")))
    print("history:", json.dumps(fabric.history, indent=1)[:2000])
    print("events:")
    for e in run.events:
        print(f"  t={e['time']:.2f} {e['code']} {e['details'].get('state','')}")
    print(f"workdir: {workdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
