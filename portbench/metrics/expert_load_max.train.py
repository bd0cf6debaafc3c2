"""expert_load_max.train: how far the busiest held expert's rows stand above
the held experts' mean, over the traced flow run's ``moe.route`` spans
(``portbench.harness.spans``): the calls' summed ``held_max_rows`` over
their summed mean rows an expert (``held_rows`` / ``held_experts``), a ratio
of 1 for an even load.  Nothing is read where no span counted held rows."""

from portbench.harness.spans import program_of, span_attr, span_stat


def read(run):
    p = program_of(run)
    rows = span_attr(p, "moe.route", "held_rows") if p else 0
    if not rows:
        return None
    experts = span_attr(p, "moe.route", "held_experts") / span_stat(p, "moe.route", "count")
    return span_attr(p, "moe.route", "held_max_rows") / (rows / experts)
