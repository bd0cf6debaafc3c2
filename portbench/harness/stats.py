"""Order statistics as the benchmark reports them: over every sample."""

from __future__ import annotations


def percentile(values, q: float) -> float:
    """The q-th percentile of all ``values``, linear between the two nearest
    ranks (numpy's default): p95 of 1..100 is 95.05."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
