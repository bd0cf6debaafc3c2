"""Automation services driving the PyTorch fabric, on the CPU.

The two flows of ``tests/test_integration.py`` — flow-orchestrated training
with an injected ``NodeFailure`` and a checkpoint restore, and an
orchestrator crash recovered by journal replay — run here on the port's
``TrainingFabric`` through the port's copy of the control plane
(``repro_torch.core``).  A checkpoint written by the JAX fabric restores into
the torch fabric, after which both train on the same batches to the same
losses; and the launcher runs its segmented flow end to end.
"""

import threading

import pytest

# the port's tests need torch beside jax; without it they are not collected
torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.train.fabric import TrainingFabric as JaxFabric
from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import asl
from repro_torch.core.actions import ActionRegistry
from repro_torch.core.clock import RealClock
from repro_torch.core.engine import FlowEngine, PollingPolicy
from repro_torch.core.errors import NodeFailure
from repro_torch.core.flows_service import FlowsService
from repro_torch.core.journal import Journal
from repro_torch.core.providers import ComputeProvider, SearchProvider
from repro_torch.launch import train as train_launcher
from repro_torch.train.fabric import TrainingFabric

FAST_POLL = PollingPolicy(initial_seconds=0.02, cap_seconds=0.2, use_callbacks=True)
TRAIN = dict(total_steps=40, warmup_steps=1, learning_rate=1e-3)


@pytest.fixture(scope="module")
def fabric(tmp_path_factory):
    cfg = configs.get("internlm2-1.8b", smoke=True)
    return TrainingFabric(cfg, TrainConfig(**TRAIN), batch=2, seq_len=16,
                          ckpt_dir=str(tmp_path_factory.mktemp("ckpt")), device="cpu")


def build_flow(fabric, registry, compute):
    reg = fabric.register_all(compute)
    fns, eid = reg["functions"], reg["endpoint_id"]

    def c(fid):
        return {"Type": "Action", "ActionUrl": "ap://compute",
                "Parameters": {"endpoint_id": eid, "function_id": fid, "kwargs": {}}}

    return {
        "StartAt": "Train",
        "States": {
            "Train": {**c(fns["train_steps"]), "ResultPath": "$.train",
                      "Catch": [{"ErrorEquals": ["ActionFailedException"],
                                 "ResultPath": "$.failure", "Next": "Restore"}],
                      "Next": "Checkpoint"},
            "Restore": {**c(fns["restore_latest"]), "ResultPath": "$.restored",
                        "Next": "Train"},
            "Checkpoint": {**c(fns["save_checkpoint"]), "ResultPath": "$.ckpt", "Next": "Eval"},
            "Eval": {**c(fns["evaluate"]), "ResultPath": "$.eval", "Next": "Catalog"},
            "Catalog": {"Type": "Action", "ActionUrl": "ap://search",
                        "Parameters": {"operation": "ingest", "index": "runs",
                                       "subject": "integration", "entry.$": "$.eval.details"},
                        "ResultPath": "$.catalog", "End": True},
        },
    }


def _stack(clock):
    registry = ActionRegistry()
    compute = ComputeProvider(clock=clock)
    search = SearchProvider(clock=clock)
    search.modeled_latency_s = 0.0
    registry.register(compute)
    registry.register(search)
    return registry, compute, search


def test_flow_orchestrated_training_with_failure_recovery(fabric):
    clock = RealClock()
    registry, compute, search = _stack(clock)
    flows = FlowsService(registry, clock=clock, polling=FAST_POLL)

    fabric.save_checkpoint()
    start_step = int(fabric.state.step)
    fabric.inject_failure_at = start_step + 3  # fail mid-segment
    record = flows.publish_flow(build_flow(fabric, registry, compute), title="integration-train")
    run = flows.run_flow(record.flow_id, {}, label="integration")
    flows.engine.wait(run.run_id, timeout=600)
    flows.engine.shutdown()

    assert run.status == "SUCCEEDED", run.error
    # the failure path was exercised: NodeFailure surfaced as the action's failure
    assert run.context.get("failure", {}).get("Error") == "ActionFailedException"
    assert "NodeFailure" in str(run.context["failure"])
    restored = run.context["restored"]["details"]["results"][0]
    assert restored["restored_step"] == start_step
    # training completed a full segment after recovery
    final = run.context["train"]["details"]["results"][0]
    assert final["step"] >= start_step + 10
    assert "integration" in search.entries("runs")


def test_engine_crash_recovery_resumes_training_flow(fabric, tmp_path):
    """Orchestrator crash: new engine + journal replay resumes the run.  The
    first train_steps call is gated on a rendezvous, so the crash is provably
    mid-action (as in the reference's test)."""
    journal_path = str(tmp_path / "journal.jsonl")
    clock = RealClock()
    registry, compute, _ = _stack(clock)
    definition = build_flow(fabric, registry, compute)

    started, release = threading.Event(), threading.Event()
    cf = next(f for f in compute._functions.values() if f.name == "train_steps")
    inner_train = cf.fn

    def gated_train(**kwargs):
        started.set()
        assert release.wait(timeout=120), "gated train step never released"
        return inner_train(**kwargs)

    cf.fn = gated_train

    flow = asl.parse(definition)
    engine1 = FlowEngine(registry, clock=clock, journal=Journal(journal_path), polling=FAST_POLL)
    run1 = engine1.start_run(flow, {}, flow_id="train-flow")
    assert started.wait(timeout=30), "Train action never dispatched"
    engine1.shutdown()
    assert run1.status == "ACTIVE"  # crashed mid-flight, not after the end
    # freeze the dead orchestrator's run object (its worker is parked in the gate)
    run1.status = "ABORTED"

    engine2 = FlowEngine(registry, clock=clock, journal=Journal(journal_path), polling=FAST_POLL)
    resumed = engine2.recover({"train-flow": flow})
    assert [r.run_id for r in resumed] == [run1.run_id]
    release.set()  # the in-flight compute action now completes
    run2 = engine2.wait(run1.run_id, timeout=600)
    engine2.shutdown()
    assert run2.status == "SUCCEEDED", run2.error
    assert run2.context["eval"]["details"]["results"][0]["eval_loss"] > 0


def test_fabric_functions(tmp_path):
    cfg = configs.get("internlm2-1.8b", smoke=True)
    fab = TrainingFabric(cfg, TrainConfig(**TRAIN), batch=2, seq_len=8,
                         ckpt_dir=str(tmp_path), device="cpu")
    assert fab.state.params["embed"]["table"].device.type == "cpu"
    fab.inject_failure_at = 1
    first = fab.train_steps(n_steps=1)
    assert first["step"] == 1 and sorted(first) == ["grad_norm", "loss", "lr", "seconds", "step"]
    with pytest.raises(NodeFailure, match="step 1"):
        fab.train_steps(n_steps=1)
    assert fab.inject_failure_at is None
    out = fab.save_checkpoint(synchronous=False)
    assert out["step"] == 1 and out["checkpoint"].endswith("(async)")
    fab.train_steps(n_steps=2)
    assert fab.restore_latest() == {"restored_step": 1}
    assert int(fab.state.step) == 1
    assert fab.export_metrics()["step"] == 1 and len(fab.export_metrics()["history"]) == 2
    assert fab.evaluate(n_batches=1)["eval_loss"] > 0
    # reshard without a mesh rebuilds the step and restores the latest checkpoint
    fab.train_steps(n_steps=1)
    assert fab.reshard(None) == {"old_mesh": None, "new_mesh": None, "member": True,
                                 "restored_step": 1}
    assert int(fab.state.step) == 1 and fab.train_steps(n_steps=1)["step"] == 2


def test_fabric_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = configs.get("internlm2-1.8b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainingFabric(cfg, TrainConfig(), batch=2, seq_len=8, ckpt_dir=str(tmp_path))


def test_jax_fabric_checkpoint_resumes_on_the_torch_fabric(tmp_path):
    """The JAX fabric saves step 0; the torch fabric restores it; both then
    train on the same synthetic batches, and their losses agree."""
    kw = dict(compute_dtype="float32")
    jcfg = jax_configs.get("internlm2-1.8b", smoke=True).replace(**kw)
    tcfg = configs.get("internlm2-1.8b", smoke=True).replace(**kw)
    j_fab = JaxFabric(jcfg, JaxTrainConfig(**TRAIN), batch=2, seq_len=16,
                      ckpt_dir=str(tmp_path / "jax"))
    t_fab = TrainingFabric(tcfg, TrainConfig(**TRAIN), batch=2, seq_len=16,
                           ckpt_dir=str(tmp_path / "jax"), device="cpu")
    assert j_fab.save_checkpoint()["step"] == 0
    assert t_fab.restore_latest() == {"restored_step": 0}
    for _ in range(5):
        j, t = j_fab.train_steps(n_steps=1), t_fab.train_steps(n_steps=1)
        assert t["step"] == j["step"]
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-4)
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-5)
    assert t_fab.evaluate()["eval_loss"] == pytest.approx(j_fab.evaluate()["eval_loss"], rel=1e-4)
    assert [r["step"] for r in t_fab.history] == [r["step"] for r in j_fab.history] == [1, 2, 3,
                                                                                          4, 5]


def test_training_launcher_recovers_from_a_node_failure(tmp_path, capsys):
    argv = ["--simulate-failure", "--device", "cpu", "--workdir", str(tmp_path),
            "--steps-per-segment", "3"]
    assert train_launcher.main(argv) == 0
    out = capsys.readouterr().out
    assert ": SUCCEEDED" in out and "StateEntered Restore" in out
    assert '"step": 6' in out  # two segments of 3 steps, one restored
