"""causal_roofline.train: the training attention pair's share (%) of its
roofline in the traced flow run: the least time its launches could take at the
bf16 peak, over the device time of its launches (``portbench.harness.spans``).

The program's ``attention.causal_fwd`` and ``attention.causal_bwd`` spans hold
the launches alone and count ``qk_pairs`` (the unmasked query-key pairs of
every head times the q.k width) and ``v_pairs`` (the same times v's).  The
forward's products are 2 (qk + v) FLOP, the backward's five 2 (3 qk + 2 v):
S, dQ and dK over q.k, dP and dV over v.  Nothing is read where no such span
ran."""

from portbench.harness.peaks import PEAK_FLOPS
from portbench.harness.spans import program_of, span_attr, span_stat

FWD, BWD = "attention.causal_fwd", "attention.causal_bwd"


def read(run):
    p = program_of(run)
    if not p or not span_stat(p, FWD, "count"):
        return None
    flops = (2 * (span_attr(p, FWD, "qk_pairs") + span_attr(p, FWD, "v_pairs"))
             + 2 * (3 * span_attr(p, BWD, "qk_pairs") + 2 * span_attr(p, BWD, "v_pairs")))
    spent = span_stat(p, FWD, "device_total_s") + span_stat(p, BWD, "device_total_s")
    return 100.0 * flops / PEAK_FLOPS["bfloat16"] / spent if spent > 0 else None
