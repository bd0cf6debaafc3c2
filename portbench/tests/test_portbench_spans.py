"""The program's spans joined with a device-only trace (``harness/spans.py``):
by hand on a made-up trace, on the CPU at SMOKE sizes through both drivers,
and (``chip``) around a bf16 matmul on the card."""

import time

import pytest

from portbench.harness import bench, spans
from portbench.harness.trace import reduce_trace
from portbench.tests.smoke import smoke_root

NEW = ("attention_share.train", "adamw_device_ms.train", "step_boundary_idle_ms.train",
       "flow_dispatch_share.train", "decode_launch_ms.serve", "sample_wait_ms.serve",
       "decode_device_ms.serve", "batch_padding_share.serve", "moe_dropped_share.serve")
OFFSET = 1000.0  # the made-up trace's clock less perf_counter_ns / 1000, us
MAIN, AUTOGRAD = 7, 9  # threads
SEED = 2**31 + 777


def _marks_and_events(shift_last=0.0, lost=()):
    """Two anchors of TRIES launches GAPS_S apart (brackets of 4 us, launches
    of 2 us one us in), at -2000 and 2000 us, their runtime events and
    kernels; the last anchor's launches ``shift_last`` us later on the
    trace's clock; the launches (mark, try) in ``lost`` missing from the trace."""
    marks, events, corr = [], [], 9000
    starts = [0.0]
    for gap in spans.GAPS_S:
        starts.append(starts[-1] + gap * 1e6)
    for m, base in enumerate((-2000.0, 2000.0)):
        tries = []
        for k in range(spans.TRIES):
            t = base + starts[k]
            tries.append((int(t * 1e3), int((t + 4) * 1e3)))
            ts = t + OFFSET + 1 + (shift_last if m else 0.0)
            corr += 1
            if (m, k) in lost:
                continue
            events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
                           "tid": MAIN, "args": {"correlation": corr}})
            events.append({"cat": "kernel", "name": "at::cuda::(anonymous)::spin_kernel(long)",
                           "ts": ts + 5, "dur": 1, "args": {"correlation": corr}})
        marks.append(tries)
    return marks, events


def _launched(events, corr, at_us, tid, start, dur, cat="kernel", name="k"):
    events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": at_us + OFFSET,
                   "dur": 3, "tid": tid, "args": {"correlation": corr}})
    events.append({"cat": cat, "name": name, "ts": start + OFFSET, "dur": dur,
                   "args": {"correlation": corr}})


def _span(i, name, start_us, end_us, parent=None, thread=MAIN, **attrs):
    return {"name": name, "id": i, "parent": parent, "trace": 1, "thread": thread,
            "start_ns": int(start_us * 1e3), "end_ns": int(end_us * 1e3), "attrs": attrs}


def test_device_time_idle_gaps_and_host_time_by_span():
    marks, events = _marks_and_events()
    _launched(events, 1, 160, MAIN, 200, 50, name="attention_kernel")
    _launched(events, 2, 300, MAIN, 300, 100)
    _launched(events, 3, 400, AUTOGRAD, 450, 10)  # its thread holds no span
    _launched(events, 4, 600, MAIN, 600, 10, cat="gpu_memcpy", name="Memcpy HtoD")
    _launched(events, 5, 420, AUTOGRAD, 470, 5)  # in a root span of that thread
    program = [_span(1, "serve.decode_step", 100, 500, step=0),
               _span(6, "block.ffn", 410, 430, thread=AUTOGRAD, backward=True),
               _span(2, "block.attention", 150, 250, parent=1, layer=0),
               _span(3, "moe.route", 510, 520, assignments=8, placed=6),
               _span(4, "moe.route", 530, 540, assignments=8, placed=7, wait_max=3.0),
               _span(5, "other", 545, 546, wait_max=5.0)]
    out = spans.join(events, program, marks)
    assert out["offset_us"] == pytest.approx(OFFSET)
    assert out["disagreement_us"] == pytest.approx(0.0)
    assert out["bound_us"] == pytest.approx(1.0)  # a 4 us bracket around a 2 us launch
    by = out["by_span"]
    us = pytest.approx
    assert by["block.attention"]["device_self_s"] == us(50e-6)
    assert by["serve.decode_step"]["device_self_s"] == us(110e-6)
    # with the 5 us of the other thread's root span, which it holds
    assert by["serve.decode_step"]["device_total_s"] == us(165e-6)
    assert by["block.ffn"]["device_self_s"] == by["block.ffn"]["device_total_s"] == us(5e-6)
    assert [by[n]["device_n"] for n in ("serve.decode_step", "block.attention", "block.ffn")] \
        == [2, 1, 1]
    assert out["unattributed_s"] == us(10e-6) and out["device_s"] == us(175e-6)
    # gaps from the first anchor's end (-997) to the last's start (2001): the
    # ones starting at 250 (the attention span has just ended), 400 and 475
    # fall in the decode step; -997 and 610 in no span
    assert by["serve.decode_step"]["idle_s"] == us(235e-6)
    assert by["block.attention"]["idle_s"] == 0.0
    assert out["idle_s"] == us((1197 + 50 + 50 + 135 + 1391) * 1e-6)
    assert out["window_s"] == us(2998e-6)
    assert by["serve.decode_step"]["host_s"] == us(400e-6) and by["moe.route"]["count"] == 2
    assert by["moe.route"]["attrs"] == {"assignments": 16, "placed": 13, "wait_max": 3.0}
    assert by["other"]["attrs"] == {"wait_max": 5.0}


def test_anchors_that_disagree_are_rejected():
    marks, events = _marks_and_events(shift_last=49.0)
    assert spans.clock_offset(events, marks)["disagreement_us"] == pytest.approx(49.0)
    marks, events = _marks_and_events(shift_last=51.0)
    with pytest.raises(spans.ClockError, match="disagree"):
        spans.join(events, [], marks)
    with pytest.raises(spans.ClockError, match="anchor 1"):
        spans.clock_offset(events[: 2 * spans.TRIES], marks)
    with pytest.raises(spans.ClockError, match="0 anchor launches"):
        spans.clock_offset([], marks)


@pytest.mark.parametrize("lost", [((0, 0),), ((0, 0), (0, 1), (1, 2)), ((0, 1), (1, 0))])
def test_a_launch_the_trace_lost_moves_no_other_onto_a_wrong_bracket(lost):
    marks, events = _marks_and_events(shift_last=3.0, lost=lost)
    out = spans.clock_offset(events, marks)
    assert out["offset_us"] == pytest.approx(OFFSET + 1.5)
    assert out["disagreement_us"] == pytest.approx(3.0)


def test_new_readers_read_nothing_without_the_programs_spans():
    t = reduce_trace([{"cat": "kernel", "ts": 0, "dur": 10, "name": "k"}], 1e-4)
    for name in NEW:
        read = bench.reader(name)
        assert read({"trace": None}) is None, name
        assert read({"trace": t}) is None, name
        assert read({}) is None, name


def test_existing_readers_read_the_same_with_the_programs_spans():
    events = [{"cat": "kernel", "ts": 0, "dur": 100, "name": "copy_kernel"},
              {"cat": "kernel", "ts": 150, "dur": 50, "name": "flash_attention_bf16"},
              {"cat": "cpu_op", "ts": -10, "dur": 400, "name": "aten::mm"}]
    record = {"tokens": 3000, "window_s": 12.0, "token_gaps_ms": [40.0, 41.0, 90.0],
              "setup_s": 20.0, "adamw_s": [0.12, 0.125], "prefill_s": [0.5],
              "decode_s": [0.05, 0.06], "steady_s": 10.0, "steady_span_s": 9.9,
              "model_flops_steady": 1e15, "flash_bound_s": 20e-6,
              "trace": reduce_trace(events, 1e-3)}
    marks, trace = _marks_and_events()
    with_program = dict(record, trace=dict(record["trace"],
                                           program=spans.join(trace, [], marks)))
    names = [p.stem for p in (bench.ROOT / "portbench" / "metrics").glob("*.py")]
    old = sorted(set(names) - set(NEW))
    assert len(old) == 15
    for name in old:
        read = bench.reader(name)
        assert read(record) == read(with_program), name
        assert read(record) is not None, name


def _smoke(tmp_path, cell, monkeypatch):
    """A traced SMOKE run of ``cell`` on the CPU, its driver's window the
    joined one: (the result's checks, the run's record)."""
    root = smoke_root(tmp_path)
    c = bench.load_cell(cell, root)
    drv = bench.driver(c)
    monkeypatch.setattr(drv, "run_window", spans.run_window)
    out = drv.run(c, SEED, 0.2, True, "cpu", time.perf_counter())
    return c, out


def test_the_joined_window_reads_every_new_metric_at_smoke_sizes(tmp_path, monkeypatch):
    from portbench.traffic.closed_loop import prompt_lengths

    cell, out = _smoke(tmp_path / "serve", "mixtral-serve-decode", monkeypatch)
    assert out["correct"], out["checks"]
    rec = out["record"]
    program = rec["trace"]["program"]
    assert program["disagreement_us"] <= spans.AGREE_US
    lengths = prompt_lengths(cell.traffic)
    slots = len(lengths) * max(lengths)
    assert bench.reader("batch_padding_share.serve")(rec) == \
        pytest.approx(100.0 * (slots - sum(lengths)) / slots)
    new = cell.traffic["new_tokens"]
    by = program["by_span"]
    assert by["serve.batch"]["count"] == 2  # the device-only units
    assert by["serve.decode_step"]["count"] == 2 * (new - 1)
    assert by["moe.route"]["count"] == 2 * 2 * new  # 2 layers
    assert 0 <= bench.reader("moe_dropped_share.serve")(rec) < 100
    assert bench.reader("decode_launch_ms.serve")(rec) > 0
    assert bench.reader("sample_wait_ms.serve")(rec) > 0
    # no device here: nothing is charged
    assert bench.reader("decode_device_ms.serve")(rec) == 0.0
    assert bench.read_metrics(cell.per_layer, rec, cell.root).keys() == \
        {"prefill_ms.serve", "decode_step_ms.serve", "step_mfu.serve"}

    cell, out = _smoke(tmp_path / "train", "internlm2-train-2k", monkeypatch)
    assert out["correct"], out["checks"]
    rec = out["record"]
    by = rec["trace"]["program"]["by_span"]
    steps = cell.traffic["steps_per_flow"]
    assert by["flows.run"]["count"] == by["compute.function"]["count"] == 1
    for name in ("fabric.step", "fabric.batch", "fabric.step_sync", "train.grad",
                 "train.adamw"):
        assert by[name]["count"] == steps, name
    assert 0 < bench.reader("flow_dispatch_share.train")(rec) < 100
    assert bench.reader("step_boundary_idle_ms.train")(rec) >= 0
    assert bench.reader("adamw_device_ms.train")(rec) == 0.0
    assert bench.reader("attention_share.train")(rec) is None  # no device time
    from repro_torch import tracing

    assert not tracing.enabled() and tracing.drain() == []


def test_a_program_without_tracing_gives_no_join(monkeypatch):
    monkeypatch.setattr(spans, "program_tracing", lambda: None)
    def unit():
        return {"start": time.perf_counter(), "end": time.perf_counter()}

    start, done, summary = spans.run_window(unit, 0.0, True, "cpu", 1)
    assert "program" not in summary and len(done) == 4


@pytest.mark.chip
def test_a_matmul_inside_a_span_is_charged_to_it(cuda_device):
    import torch

    from repro_torch import tracing

    a = torch.randn(4096, 4096, device=cuda_device, dtype=torch.bfloat16)
    (a @ a).sum().item()
    with spans.ProgramWindow(cuda_device) as w:
        with tracing.span("outer"):
            with tracing.span("mm"):
                b = a @ a
            c = b.float()
        torch.cuda.synchronize()
    p = w.program
    assert p["disagreement_us"] <= spans.AGREE_US, p
    mm = p["by_span"]["mm"]
    gemm = sum(s for name, s in w.summary["by_name"].items() if "copy" not in name)
    assert mm["device_self_s"] > 0 and mm["device_self_s"] == pytest.approx(gemm, rel=0.01)
    assert p["by_span"]["outer"]["device_total_s"] == pytest.approx(p["device_s"])
    assert p["unattributed_s"] == 0.0
    del c
