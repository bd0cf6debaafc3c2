"""decode_device_ms.serve: the device time charged to the program's
``serve.decode_step`` spans and the spans inside them, mean a step, in the
traced batches (``portbench.harness.spans``)."""

from portbench.harness.spans import program_of, span_stat


def read(run):
    p = program_of(run)
    steps = span_stat(p, "serve.decode_step", "count") if p else 0
    if not steps:
        return None
    return 1e3 * span_stat(p, "serve.decode_step", "device_total_s") / steps
