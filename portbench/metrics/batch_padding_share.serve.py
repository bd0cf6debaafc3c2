"""batch_padding_share.serve: pad tokens over the batches' slots (requests x
width), as a share (%), summed over the program's ``serve.batch`` spans in the
traced batches (``portbench.harness.spans``)."""

from portbench.harness.spans import program_of, span_attr


def read(run):
    p = program_of(run)
    if not p:
        return None
    pad = span_attr(p, "serve.batch", "pad_tokens")
    slots = pad + span_attr(p, "serve.batch", "prompt_tokens")
    return 100.0 * pad / slots if slots else None
