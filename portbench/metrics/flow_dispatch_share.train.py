"""flow_dispatch_share.train: the share (%) of the program's ``flows.run``
spans (a run's start to its terminal state) not inside its
``compute.function`` spans (the registered function running), by the
program's host clock, in the traced flow run (``portbench.harness.spans``)."""

from portbench.harness.spans import program_of, span_stat


def read(run):
    p = program_of(run)
    total = span_stat(p, "flows.run", "host_s") if p else 0
    if not total:
        return None
    return 100.0 * (total - span_stat(p, "compute.function", "host_s")) / total
