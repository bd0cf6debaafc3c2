"""step_boundary_idle_ms.train: the device's idle time in gaps that start
inside the program's ``fabric.batch`` (the batch made and copied to the
device) or ``fabric.step_sync`` (the step count read back), a step, in the
traced flow run (``portbench.harness.spans``)."""

from portbench.harness.spans import program_of, span_stat


def read(run):
    p = program_of(run)
    steps = span_stat(p, "fabric.step", "count") if p else 0
    if not steps:
        return None
    idle = span_stat(p, "fabric.batch", "idle_s") + span_stat(p, "fabric.step_sync", "idle_s")
    return 1e3 * idle / steps
