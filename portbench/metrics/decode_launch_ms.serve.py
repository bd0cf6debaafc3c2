"""decode_launch_ms.serve: the host time of the program's
``serve.decode_step`` spans, mean a step, in the traced batches
(``portbench.harness.spans``): the host's enqueue of a step, with no
synchronise around it."""

from portbench.harness.spans import program_of, span_stat


def read(run):
    p = program_of(run)
    steps = span_stat(p, "serve.decode_step", "count") if p else 0
    if not steps:
        return None
    return 1e3 * span_stat(p, "serve.decode_step", "host_s") / steps
