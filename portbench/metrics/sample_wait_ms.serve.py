"""sample_wait_ms.serve: the host time of the program's ``serve.sample`` spans
(the argmax's copy to the host, which waits for the step's logits, and the
next token's copy back), mean a sample, in the traced batches
(``portbench.harness.spans``)."""

from portbench.harness.spans import program_of, span_stat


def read(run):
    p = program_of(run)
    n = span_stat(p, "serve.sample", "count") if p else 0
    if not n:
        return None
    return 1e3 * span_stat(p, "serve.sample", "host_s") / n
