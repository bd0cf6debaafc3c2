"""The least time the attention kernel could take for a launch, kept apart
from the kernel so that it counts the same work whatever implements it.

A copy of ``attention_bound_ms`` in the repository's ``chip_smoke.py``: each
input byte read once and the output written once at the HBM rate, or the QK^T
and PV products over the unmasked (causal, in-window) pairs at the dtype's
peak, whichever is larger.  Shapes are the launch's own, padding included.
"""

from __future__ import annotations

from portbench.harness.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def unmasked_pairs(S: int, T: int, causal: bool, window: int | None) -> int:
    """Query-key pairs (query i of S, key j of T, aligned at the start) that
    the mask keeps: j <= i when causal, i - j < window with a window."""
    total = 0
    for i in range(S):
        hi = min(i, T - 1) if causal else T - 1
        lo = max(0, i - window + 1) if window is not None else 0
        if hi >= lo:
            total += hi - lo + 1
    return total


def attention_bound_s(dtype: str, B: int, S: int, T: int, H: int, K: int, D: int,
                      causal: bool, window: int | None) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the bound and which term sets it."""
    nbytes = ESIZE[dtype] * (2 * B * S * H * D + 2 * B * T * K * D)
    flops = 4 * B * H * D * unmasked_pairs(S, T, causal, window)
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"
