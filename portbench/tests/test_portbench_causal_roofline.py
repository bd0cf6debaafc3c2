"""``causal_roofline.train``, the training attention pair's share of its
roofline, on hand-made joins: the forward's two products and the backward's
five over the summed ``qk_pairs`` and ``v_pairs`` of the program's
``attention.causal_fwd`` and ``attention.causal_bwd`` spans, over their device
time; nothing where the program has no such span (the parent of the pair's
spans) or no join at all."""

import pytest

from portbench.harness import bench
from portbench.harness.peaks import PEAK_FLOPS

READ = bench.reader("causal_roofline.train")


def _run(by_span):
    return {"trace": {"program": {"device_s": 10.0, "by_span": by_span}}}


def test_the_products_over_the_spans_device_time():
    # two forwards and one backward of moonlight's layer: 16 x 16 heads of
    # 2048 (2049) / 2 pairs, q.k 192, v 128
    pairs = 16 * 16 * 2048 * 2049 // 2
    fwd = {"count": 2, "device_total_s": 2 * 0.786e-3,
           "attrs": {"qk_pairs": 2 * 192 * pairs, "v_pairs": 2 * 128 * pairs}}
    bwd = {"count": 1, "device_total_s": 3.185e-3,
           "attrs": {"qk_pairs": 192 * pairs, "v_pairs": 128 * pairs}}
    flops = 2 * 2 * 320 * pairs + 2 * (3 * 192 + 2 * 128) * pairs
    want = 100.0 * flops / PEAK_FLOPS["bfloat16"] / (2 * 0.786e-3 + 3.185e-3)
    got = READ(_run({"attention.causal_fwd": fwd, "attention.causal_bwd": bwd}))
    assert got == pytest.approx(want)
    assert 0 < got < 100


@pytest.mark.parametrize("run", [
    {},
    {"trace": {}},
    _run({"block.attention": {"count": 2, "device_total_s": 0.5, "attrs": {}},
          "attention.mla": {"count": 2, "device_total_s": 0.1, "attrs": {}}}),
])
def test_nothing_to_read_reads_nothing(run):
    assert READ(run) is None
