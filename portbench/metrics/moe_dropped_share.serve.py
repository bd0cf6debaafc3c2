"""moe_dropped_share.serve: the share (%) of the router's top-k assignments
that no expert slot took (past capacity), over every ``moe.route`` span of
the traced batches, pad tokens included: 1 - placed / assignments
(``portbench.harness.spans``)."""

from portbench.harness.spans import program_of, span_attr


def read(run):
    p = program_of(run)
    assigned = span_attr(p, "moe.route", "assignments") if p else 0
    if not assigned:
        return None
    return 100.0 * (1.0 - span_attr(p, "moe.route", "placed") / assigned)
