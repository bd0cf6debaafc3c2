"""adamw_device_ms.train: the device time charged to the program's
``train.adamw`` span, a step (``fabric.step`` spans), in the traced flow run
(``portbench.harness.spans``): no synchronise around it."""

from portbench.harness.spans import program_of, span_stat


def read(run):
    p = program_of(run)
    steps = span_stat(p, "fabric.step", "count") if p else 0
    if not steps:
        return None
    return 1e3 * span_stat(p, "train.adamw", "device_total_s") / steps
