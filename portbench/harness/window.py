"""The measured window: units of work (a flow run, a served batch) back to
back for ``seconds``, the unit in flight at the close finished and counted.

A traced run first traces ``n_profiled`` whole units with device operations
alone (the per-layer metrics and the top device operations read this
trace), then one more unit with host operations as well, whose idle gaps are
named by what the host was doing; both are marked ``profiled``, and the
host-clock metrics read the other units, of which it runs at least
``STEADY_TRACED``.  The driver's own timers (which synchronise around the
calls they time) are switched on by ``before_steady`` only then, so the
traced units run the program as an untraced run does.
"""

from __future__ import annotations

import contextlib
import time

from portbench.harness.trace import Profiled

STEADY_TRACED = 2


def span(name: str, on: bool):
    """A named range in the trace (``portbench.<name>``) where ``on``."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(f"portbench.{name}")


def run_window(next_unit, seconds: float, trace: bool, device: str, n_profiled: int,
               min_units: int = 1, before_steady=None):
    """(start, units, trace summary or None); ``next_unit()`` returns a dict
    with at least ``start`` and ``end`` (host clock).  At least ``min_units``
    units run.  In a traced run ``before_steady()``, where given, is called
    once the traced units are done."""
    units, summary = [], None
    start = time.perf_counter()
    if trace:
        with Profiled(device, host_ops=False) as dev:
            for _ in range(n_profiled):
                units.append(dict(next_unit(), profiled=True))
        with Profiled(device, host_ops=True) as host:
            units.append(dict(next_unit(), profiled=True))
        summary = dict(dev.summary, idle_gaps=host.summary["idle_gaps"])
        min_units = max(min_units, len(units) + STEADY_TRACED)
        if before_steady is not None:
            before_steady()
    while len(units) < min_units or units[-1]["end"] - start < seconds:
        units.append(next_unit())
    return start, units, summary
