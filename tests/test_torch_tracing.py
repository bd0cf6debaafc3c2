"""The program's spans and counters (``repro_torch.tracing``): the module on its
own, then the span tree and its counts that serving and training leave at
SMOKE sizes on the CPU, and that turning them on changes no output."""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, tracing
from repro_torch.configs.base import TrainConfig
from repro_torch.core.actions import ActionRegistry
from repro_torch.core.clock import RealClock
from repro_torch.core.engine import PollingPolicy
from repro_torch.core.flows_service import FlowsService
from repro_torch.core.providers import ComputeProvider
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import Model
from repro_torch.serve.engine import BatchAccumulator, ServeEngine
from repro_torch.train.fabric import TrainingFabric


@pytest.fixture
def traced():
    """Tracing on for the test, off and empty after it."""
    tracing.drain()
    tracing.enable()
    yield
    tracing.disable()
    tracing.drain()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


# ----------------------------------------------------------------- the module


def test_off_records_nothing_and_returns_the_shared_noop():
    tracing.disable()
    tracing.drain()
    a, b = tracing.span("a", n=1), tracing.span("b")
    assert a is b
    with a as s:
        s.set(n=2)
    tracing.begin("run", "k")
    with tracing.inside("k"):
        with tracing.span("c"):
            pass
    tracing.end("k")
    assert tracing.drain() == []
    assert not tracing.enabled()


def test_nesting_gives_parents_and_one_trace_per_root_on_each_thread(traced):
    def work(tag):
        with tracing.span("outer", tag=tag):
            with tracing.span("inner"):
                with tracing.span("leaf"):
                    pass
            with tracing.span("inner"):
                pass

    work("main")
    t = threading.Thread(target=work, args=("other",))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    spans = tracing.drain()
    assert len(spans) == 8
    roots = [s for s in spans if s["parent"] is None]
    assert sorted(r["attrs"]["tag"] for r in roots) == ["main", "other"]
    assert roots[0]["thread"] != roots[1]["thread"]
    for root in roots:
        mine = [s for s in spans if s["trace"] == root["id"]]
        assert len(mine) == 4 and all(s["thread"] == root["thread"] for s in mine)
        inner = _children(spans, root)
        assert [s["name"] for s in inner] == ["inner", "inner"]
        assert [s["name"] for s in _children(spans, inner[0])] == ["leaf"]
        for s in mine:
            assert s["start_ns"] <= s["end_ns"]
            if s["parent"] is not None:
                p = next(q for q in spans if q["id"] == s["parent"])
                assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]


def test_begin_and_end_on_other_threads_and_inside(traced):
    tracing.begin("flows.run", "run-1", flow_id="f")
    done = threading.Event()

    def dispatcher():
        tracing.begin("flows.action", "run-1:A:0", under="run-1", state="A")
        with tracing.inside("run-1:A:0"):
            with tracing.span("compute.function"):
                pass
        tracing.end("run-1:A:0", status="SUCCEEDED")
        tracing.end("run-1", status="SUCCEEDED")
        done.set()

    t = threading.Thread(target=dispatcher)
    t.start()
    assert done.wait(timeout=30)
    t.join(timeout=30)
    tracing.end("run-1")  # already ended: nothing
    spans = _by_name(tracing.drain())
    run, action, fn = spans["flows.run"][0], spans["flows.action"][0], spans["compute.function"][0]
    assert run["parent"] is None and run["trace"] == "run-1"
    assert run["attrs"] == {"flow_id": "f", "status": "SUCCEEDED"}
    assert action["parent"] == run["id"] and action["trace"] == "run-1"
    assert action["attrs"] == {"state": "A", "status": "SUCCEEDED"}
    assert fn["parent"] == action["id"] and fn["trace"] == "run-1"
    assert run["thread"] == threading.get_native_id() != action["thread"]
    assert run["start_ns"] <= action["start_ns"] <= fn["start_ns"] <= fn["end_ns"] \
        <= action["end_ns"] <= run["end_ns"]


def test_drain_clears_and_reads_device_tensor_attrs(traced):
    x = torch.arange(10)
    with tracing.span("count", fixed=3) as s:
        s.set(total=x.sum(), mean=x.float().mean(), flag=torch.tensor(True))
    spans = tracing.drain()
    assert spans[0]["attrs"] == {"fixed": 3, "total": 45, "mean": 4.5, "flag": 1}
    assert isinstance(spans[0]["attrs"]["total"], int)
    assert tracing.drain() == []


def test_disable_drops_open_spans_and_keeps_closed_ones(traced):
    tracing.begin("left", "k")
    with tracing.span("closed"):
        pass
    tracing.disable()
    tracing.enable()
    tracing.end("k")
    assert [s["name"] for s in tracing.drain()] == ["closed"]


def test_spans_are_ranges_in_a_profilers_trace(traced, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tracing.begin("flows.run", "r")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("serve.batch"):
            with tracing.span("serve.prefill"):
                torch.ones(8) @ torch.ones(8)
        with tracing.inside("r"):
            torch.ones(2) + 1
    tracing.end("r")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"repro_torch.serve.batch", "repro_torch.serve.prefill",
            "repro_torch.flows.run"} <= names
    # without a profiler a span enters no range
    with tracing.span("quiet") as s:
        assert s._rf is None


def test_an_off_span_costs_under_a_few_hundred_ns_here():
    """10**6 off ``with span(...)`` blocks; the best of three rounds, less the
    empty loop's time, a call (PERF.md quotes the card's host)."""
    tracing.disable()
    span = tracing.span

    def rounds(body):
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter()
            body()
            best = min(best, time.perf_counter() - t)
        return best / 10**6

    def spans():
        for _ in range(10**6):
            with span("block.attention", layer=3):
                pass

    def empty():
        for _ in range(10**6):
            pass

    per_call = rounds(spans) - rounds(empty)
    assert per_call < 2.5e-6, per_call


# --------------------------------------------------------- serving at SMOKE


def _mixtral():
    cfg = configs.get("mixtral-8x7b", smoke=True)
    model = Model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0), device="cpu")
    return cfg, model, params


def _serve(cfg, model, params, prompts, new):
    engine = ServeEngine(model, params, max_len=max(map(len, prompts)) + new, device="cpu")
    accum = BatchAccumulator(engine, max_batch=3, pad_token=0)
    for p in prompts:
        accum.submit(p)
    return [r["tokens"] for r in accum.flush(max_new_tokens=new)]


def test_serving_spans_and_counts(monkeypatch):
    cfg, model, params = _mixtral()
    rng = np.random.default_rng(0)
    lengths = [5, 9, 3, 7, 4]
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]
    new = 4
    plain = _serve(cfg, model, params, prompts, new)

    masks = []  # every dispatch mask, in call order, recomputed apart from the spans
    real = moe_mod.top_k_dispatch

    def spy(logits, moe_cfg, capacity):
        out = real(logits, moe_cfg, capacity)
        masks.append(out[0].clone())
        return out

    monkeypatch.setattr(moe_mod, "top_k_dispatch", spy)
    tracing.drain()
    tracing.enable()
    try:
        traced = _serve(cfg, model, params, prompts, new)
    finally:
        tracing.disable()
    spans = tracing.drain()
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)  # bit for bit, on and off

    named = _by_name(spans)
    batches = sorted(named["serve.batch"], key=lambda s: s["start_ns"])
    assert [b["attrs"]["requests"] for b in batches] == [3, 2]
    for b, chunk in zip(batches, (lengths[:3], lengths[3:])):
        a = b["attrs"]
        assert a["width"] == max(chunk) and a["prompt_tokens"] == sum(chunk)
        assert a["pad_tokens"] == len(chunk) * max(chunk) - sum(chunk)
        assert 0 < a["queue_wait_s_max"] <= a["queue_wait_s_sum"]
        [gen] = _children(spans, b)
        assert gen["name"] == "serve.generate"
        assert gen["attrs"] == {"B": len(chunk), "S": max(chunk), "new_tokens": new}
        kids = sorted(_children(spans, gen), key=lambda s: s["start_ns"])
        names = [k["name"] for k in kids]
        # prefill, then a sample per token and a decode step after each but the last
        assert names == ["serve.prefill"] + ["serve.sample", "serve.decode_step"] * (new - 1) \
            + ["serve.sample"]
        assert [k["attrs"]["step"] for k in kids if k["name"] == "serve.decode_step"] \
            == list(range(new - 1))
        for k in kids:
            if k["name"] in ("serve.prefill", "serve.decode_step"):
                blocks = _children(spans, k)
                assert [s["name"] for s in blocks] == ["block.attention", "block.ffn"] * cfg.n_layers
                assert [s["attrs"]["layer"] for s in blocks] == \
                    [i for i in range(cfg.n_layers) for _ in range(2)]
                for ffn in blocks[1::2]:
                    assert [s["name"] for s in _children(spans, ffn)] == ["moe.route",
                                                                           "moe.experts"]
    # one routing a layer per prefill and per decode step, placed = the mask's sum
    routes = sorted(named["moe.route"], key=lambda s: s["start_ns"])
    assert len(routes) == len(masks) == 2 * cfg.n_layers * new
    k = cfg.moe.top_k
    for r, mask in zip(routes, masks):
        G, T = mask.shape[:2]
        assert r["attrs"] == {"assignments": G * T * k, "placed": int(mask.sum())}
    assert sum(r["attrs"]["placed"] for r in routes) < sum(r["attrs"]["assignments"]
                                                          for r in routes)


# -------------------------------------------------------- training at SMOKE


def _train_through_flows(tmp_path, steps, remat):
    cfg = configs.get("internlm2-1.8b", smoke=True).replace(remat_policy=remat)
    fabric = TrainingFabric(cfg, TrainConfig(total_steps=40, warmup_steps=1,
                                             learning_rate=1e-3),
                            batch=2, seq_len=16, ckpt_dir=str(tmp_path), device="cpu")
    registry = ActionRegistry()
    compute = ComputeProvider(clock=RealClock())
    registry.register(compute)
    flows = FlowsService(registry, clock=RealClock(), polling=PollingPolicy(
        initial_seconds=0.01, cap_seconds=0.2, use_callbacks=True))
    eid = compute.register_endpoint("fabric", mode="inline")
    fid = compute.register_function(fabric.train_steps, name="train_steps")
    flow = {"StartAt": "Train", "States": {"Train": {
        "Type": "Action", "ActionUrl": "ap://compute",
        "Parameters": {"endpoint_id": eid, "function_id": fid, "kwargs": {"n_steps": steps}},
        "ResultPath": "$.train", "End": True}}}
    flow_id = flows.publish_flow(flow).flow_id
    losses = []
    try:
        for _ in range(2):
            run = flows.run_flow(flow_id, {})
            flows.engine.wait(run.run_id, timeout=300)
            assert run.status == "SUCCEEDED", run.error
            losses.append(run.context["train"]["details"]["results"][0]["loss"])
    finally:
        flows.engine.shutdown()
    return losses, [p.detach().clone() for p in fabric.state.params["embed"].values()]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_training_spans_nest_from_the_flow_down(tmp_path, remat):
    steps = 2
    plain, plain_params = _train_through_flows(tmp_path / "a", steps, remat)
    tracing.drain()
    tracing.enable()
    try:
        losses, params = _train_through_flows(tmp_path / "b", steps, remat)
    finally:
        tracing.disable()
    spans = tracing.drain()
    assert losses == plain  # bit for bit, on and off
    for a, b in zip(plain_params, params):
        assert torch.equal(a, b)

    named = _by_name(spans)
    runs = named["flows.run"]
    assert len(runs) == 2 and all(r["attrs"]["status"] == "SUCCEEDED" for r in runs)
    for run in runs:
        chain = [run]
        for name in ("flows.action", "compute.function", "fabric.train_steps"):
            [child] = _children(spans, chain[-1])
            assert child["name"] == name and child["trace"] == run["trace"]
            chain.append(child)
        assert chain[1]["attrs"]["action_url"] == "ap://compute"
        assert chain[1]["attrs"]["status"] == "SUCCEEDED"
        assert chain[2]["attrs"] == {"function": "train_steps"}
        assert chain[3]["attrs"] == {"n_steps": steps}
        step_spans = _children(spans, chain[3])
        assert [s["name"] for s in step_spans] == ["fabric.step"] * steps
        for s in step_spans:
            assert s["attrs"]["tokens"] == 2 * 16
            kids = sorted(_children(spans, s), key=lambda k: k["start_ns"])
            assert [k["name"] for k in kids] == ["fabric.step_sync", "fabric.batch",
                                                 "train.grad", "train.adamw"]
            # forward and backward: a block's spans inside the gradient, the
            # remat's recompute (remat full) a second time
            grad = kids[2]
            grad_blocks = [b for b in spans if b["parent"] == grad["id"]]
            # the forward's, and under remat the recompute's in the backward
            assert sorted((b["name"], b["attrs"]["layer"]) for b in grad_blocks) == \
                sorted((n, i) for n in ("block.attention", "block.ffn") for i in range(2)
                       for _ in range(2 if remat == "full" else 1))
            # and each block's backward, a span of its own within the gradient
            backward = [b for b in spans if b["attrs"].get("backward")
                        and grad["start_ns"] <= b["start_ns"] <= b["end_ns"] <= grad["end_ns"]]
            assert sorted((b["name"], b["attrs"]["layer"]) for b in backward) == \
                sorted((n, i) for n in ("block.attention", "block.ffn") for i in range(2))
    assert sorted(s["attrs"]["step"] for s in named["fabric.step"]) == list(range(2 * steps))
