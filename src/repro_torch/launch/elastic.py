"""Elastic training: device failure -> catch -> restore onto a SMALLER mesh.
Counterpart of ``examples/elastic_training.py``.

A training job on a mesh loses devices mid-run; the training flow catches the
failure and resumes from the latest checkpoint on a smaller mesh (elastic
shrink), with all parameter and optimizer state resharded at restore time.

    PYTHONPATH=src python -m repro_torch.launch.elastic --device cpu

``--device cpu`` spawns four gloo ranks itself (the reference forces four host
devices), trains SMOKE internlm2 on a (2, 2) ``("data", "model")`` mesh,
injects a ``NodeFailure`` at step 6, reshards onto (1, 2) and trains on to
step 10 or more.  On CUDA it runs one rank per card: four cards take the same
meshes, one card goes from (1, 1) to the 1-D ``("data",)`` mesh, so that the
placements still change on restore.

The ranks are SPMD: each runs the same flow on its own ``FlowsService`` of
:mod:`repro_torch.core`, and issues its collectives from the flow engine's
thread, one action at a time, in the same order as every other rank.  The
smaller mesh is built by every rank of the world before the flow starts (mesh
creation is collective); the ranks outside it leave at the shrink: their
``reshard`` reports ``member: False`` and their flow ends in the ``Left``
state.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import FlowsService, RealClock
from repro_torch.core.actions import ActionRegistry
from repro_torch.core.engine import PollingPolicy
from repro_torch.core.providers import ComputeProvider
from repro_torch.launch.mesh import init_process_group, make_mesh
from repro_torch.train.fabric import TrainingFabric


def elastic_flow_definition(eid: str, f_train: str, f_ckpt: str, f_shrink: str) -> dict:
    """Train -> Checkpoint -> Train (NodeFailure? Shrink -> member? Train :
    Left) -> Done."""
    def action(fid, result_path):
        return {"Type": "Action", "ActionUrl": "ap://compute",
                "Parameters": {"endpoint_id": eid, "function_id": fid, "kwargs": {}},
                "ResultPath": result_path}

    return {
        "Comment": "Elastic training: failure -> reshard -> resume",
        "StartAt": "Train1",
        "States": {
            "Train1": {**action(f_train, "$.t1"), "Next": "Ckpt1"},
            "Ckpt1": {**action(f_ckpt, "$.c1"), "Next": "Train2"},
            "Train2": {
                **action(f_train, "$.t2"),
                "Catch": [{"ErrorEquals": ["ActionFailedException"],
                           "ResultPath": "$.failure", "Next": "ShrinkAndRestore"}],
                "Next": "Done"},
            "ShrinkAndRestore": {**action(f_shrink, "$.reshard"), "Next": "Member"},
            "Member": {
                "Type": "Choice",
                "Choices": [{"Variable": "$.reshard.details.results[0].member",
                             "BooleanEquals": True, "Next": "Train2"}],
                "Default": "Left"},
            "Left": {"Type": "Succeed"},
            "Done": {"Type": "Succeed"},
        },
    }


def run_elastic_flow(fabric: TrainingFabric, small_mesh, steps_per_segment: int = 5,
                     fail_at: int | None = 6, timeout: float = 1200.0):
    """Runs the elastic flow over ``fabric`` (already on its first mesh):
    a seed checkpoint, a ``NodeFailure`` injected at step ``fail_at``, the
    shrink onto ``small_mesh``.  Returns the finished run; its engine is shut
    down.  Every rank of the fabric's mesh calls it."""
    device = fabric.device

    def on_device(fn):
        # the engine's thread starts on card 0: put it on this rank's card
        def wrapped(**_):
            if device.type == "cuda" and device.index is not None:
                torch.cuda.set_device(device)
            return fn()
        return wrapped

    fabric.save_checkpoint()
    fabric.inject_failure_at = fail_at
    clock = RealClock()
    registry = ActionRegistry()
    compute = ComputeProvider(clock=clock)
    registry.register(compute)
    flows = FlowsService(registry, clock=clock,
                         polling=PollingPolicy(initial_seconds=0.02, cap_seconds=0.5,
                                               use_callbacks=True))
    eid = compute.register_endpoint("pod")
    f_train = compute.register_function(
        on_device(lambda: fabric.train_steps(n_steps=steps_per_segment)), name="train")
    f_ckpt = compute.register_function(on_device(fabric.save_checkpoint), name="ckpt")
    f_shrink = compute.register_function(on_device(lambda: fabric.reshard(small_mesh)),
                                         name="shrink")
    record = flows.publish_flow(elastic_flow_definition(eid, f_train, f_ckpt, f_shrink),
                                title="Elastic training")
    run = flows.run_flow(record.flow_id, {}, label="elastic")
    flows.engine.wait(run.run_id, timeout=timeout)
    flows.engine.shutdown()
    return run


def summary(run, fabric: TrainingFabric) -> dict:
    """What a rank reports: the run's status, the caught failure, the
    reshard's result and the loss history."""
    reshard = (run.context.get("reshard") or {}).get("details", {}).get("results", [{}])[0]
    failure = run.context.get("failure") or {}
    return {
        "status": run.status,
        "error": run.error,
        "failure": (failure.get("Details") or {}).get("error"),
        "reshard": reshard,
        "final_step": fabric.history[-1]["step"] if fabric.history else None,
        "history": [(h["step"], h["loss"]) for h in fabric.history],
    }


def run_rank(rank: int, world: int, init_method: str, device_type: str, workdir: str,
             big: tuple, small: tuple, arch: str = "internlm2-1.8b",
             steps_per_segment: int = 5, fail_at: int = 6) -> dict:
    """One rank of the elastic job: joins the world, builds both meshes (every
    rank builds both), trains on the first, shrinks onto the second.  ``big``
    and ``small`` are ``(shape, axes)`` pairs.  Returns :func:`summary`."""
    init_process_group(device_type, rank, world, init_method)
    try:
        big_mesh = make_mesh(*big, device_type=device_type)
        small_mesh = make_mesh(*small, device_type=device_type)
        device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" \
            else torch.device("cpu")
        fabric = TrainingFabric(
            configs.get(arch, smoke=True),
            TrainConfig(total_steps=30, warmup_steps=2, learning_rate=1e-3),
            batch=4, seq_len=32, ckpt_dir=os.path.join(workdir, "ckpt"),
            device=device, mesh=big_mesh,
        )
        run = run_elastic_flow(fabric, small_mesh, steps_per_segment, fail_at)
        return {"rank": rank, **summary(run, fabric)}
    finally:
        torch.distributed.destroy_process_group()


def _spawned(rank: int, world: int, init_method: str, device_type: str, workdir: str,
             big: tuple, small: tuple) -> None:
    result = run_rank(rank, world, init_method, device_type, workdir, big, small)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(result, fh)


def meshes_for(world: int) -> tuple[tuple, tuple]:
    """(first, smaller) mesh as ``(shape, axes)``: (2, 2) -> (1, 2) on four
    ranks, (1, 1) -> the 1-D (1,) ``("data",)`` mesh on one."""
    if world == 4:
        return ((2, 2), ("data", "model")), ((1, 2), ("data", "model"))
    if world == 1:
        return ((1, 1), ("data", "model")), ((1,), ("data",))
    raise ValueError(f"the elastic demo runs on 1 or 4 ranks, not {world}")


def launch(device_type: str, workdir: str) -> list[dict]:
    """Spawns the ranks (four gloo ranks on the CPU, one per card on CUDA) and
    returns each rank's :func:`summary`, in rank order."""
    import torch.multiprocessing as mp

    world = 4 if device_type == "cpu" else torch.cuda.device_count()
    big, small = meshes_for(world)
    workdir = os.path.abspath(workdir)  # a file:// rendezvous needs an absolute path
    init_method = "file://" + os.path.join(workdir, "rendezvous")
    mp.spawn(_spawned, args=(world, init_method, device_type, workdir, big, small),
             nprocs=world, join=True)
    results = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.json")) as fh:
            results.append(json.load(fh))
    return results


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--workdir", default=None)
    args = parser.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="elastic-")
    os.makedirs(workdir, exist_ok=True)
    results = launch(args.device, workdir)
    for r in results:
        print(json.dumps({k: r[k] for k in ("rank", "status", "failure", "reshard",
                                            "final_step")}))
    lead = results[0]
    print("loss history:", [(s, round(loss, 3)) for s, loss in lead["history"]])
    ok = all(r["status"] == "SUCCEEDED" for r in results) and lead["final_step"] >= 10
    print("Elastic training complete: survived device loss, resumed on the smaller mesh."
          if ok else "Elastic training FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
