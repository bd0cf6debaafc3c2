"""Percentiles over every sample, rates over the whole window, the idle share
over the whole traced window, and readers that find nothing return nothing."""

import pytest

from portbench.harness import bench
from portbench.harness.stats import percentile
from portbench.harness.trace import reduce_trace


def test_percentile_takes_every_sample():
    assert percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert percentile([5.0], 95) == 5.0
    # one slow gap among many: p95 of 100 gaps with 6 slow reads a slow one
    gaps = [40.0] * 94 + [90.0] * 6
    assert percentile(gaps, 95) == 90.0
    with pytest.raises(ValueError):
        percentile([], 95)


def test_rates_cover_the_whole_window_with_its_last_unit():
    read = bench.reader("serve_tokens_per_s")
    # three batches of 1000 tokens; the last ends 2 s past a 10 s window
    assert read({"tokens": 3000, "window_s": 12.0}) == pytest.approx(250.0)
    assert bench.reader("train_tokens_per_s")({"tokens": 65536 * 3, "window_s": 16.0}) \
        == pytest.approx(12288.0)
    # p95 of 100 gaps lies between the 95th and 96th smallest
    assert bench.reader("token_gap_p95_ms")({"token_gaps_ms": [1.0] * 95 + [50.0] * 5}) \
        == pytest.approx(1.0 + 49.0 * 0.05)


def _kernel(ts, dur, name="k"):
    return {"cat": "kernel", "ts": ts, "dur": dur, "name": name}


def test_idle_share_divides_by_the_whole_traced_window():
    # kernels busy 0-100 and 150-250 us; the host window is 1 ms: idle at both
    # edges counts, so 80 % idle, not the 20 % of first start to last end
    events = [_kernel(0, 100, "copy_kernel"), _kernel(50, 50), _kernel(150, 100, "gemm"),
              {"cat": "cpu_op", "ts": -10, "dur": 400, "name": "aten::mm"},
              {"cat": "user_annotation", "ts": -20, "dur": 600, "name": "decode"}]
    t = reduce_trace(events, window_s=1e-3)
    assert t["busy_s"] == pytest.approx(200e-6)
    assert t["device_s"] == pytest.approx(250e-6)
    assert bench.reader("device_idle_share.serve")({"trace": t}) == pytest.approx(80.0)
    assert bench.reader("cast_copy_share.serve")({"trace": t}) == pytest.approx(40.0)
    # each gap is named by what the host was doing as it began: the span's
    # start before the op (20 us), the op at the middle gap and at the tail
    names = dict(t["idle_gaps"])
    assert names["decode / no host op"] == pytest.approx(20e-6)
    assert names["decode / aten::mm"] == pytest.approx(50e-6 + 330e-6)


def test_readers_with_nothing_to_read_return_nothing():
    for name in ("device_idle_share.train", "cast_copy_share.train", "flash_roofline.serve",
                 "adamw_ms.train", "prefill_ms.serve", "step_mfu.serve",
                 "flow_overhead_share.train", "token_gap_p95_ms"):
        assert bench.reader(name)({"trace": None}) is None, name
    # a trace without the flash kernel reads no roofline, never 0
    t = reduce_trace([_kernel(0, 10, "gemm")], 1e-4)
    assert bench.reader("flash_roofline.serve")({"trace": t, "flash_bound_s": 1e-6}) is None


def test_flash_roofline_is_the_bound_over_the_kernel_time():
    t = reduce_trace([_kernel(0, 400, "void flash_attention_bf16_kernel<128>"),
                      _kernel(500, 100, "gemm")], 1e-3)
    run = {"trace": t, "flash_bound_s": 100e-6}
    assert bench.reader("flash_roofline.serve")(run) == pytest.approx(25.0)
