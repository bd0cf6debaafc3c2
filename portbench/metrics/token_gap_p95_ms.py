"""token_gap_p95_ms: the 95th percentile of the time between consecutive
output tokens, over every such pair of every request (CUDA events on the
card's stream, one after each prefill and decode step)."""

from portbench.harness.stats import percentile


def read(run):
    gaps = run.get("token_gaps_ms")
    return percentile(gaps, 95) if gaps else None
