"""moe_share.train: the device time charged to the program's ``moe.route``,
``moe.experts`` and ``moe.shared`` spans (forward, recompute, and the
experts' backward) as a share (%) of all device-operation time in the traced
flow run (``portbench.harness.spans``).  Nothing is read where no
``moe.shared`` span ran."""

from portbench.harness.spans import program_of, span_stat

SPANS = ("moe.route", "moe.experts", "moe.shared")


def read(run):
    p = program_of(run)
    if not p or not p["device_s"] or not span_stat(p, "moe.shared", "count"):
        return None
    return 100.0 * sum(span_stat(p, s, "device_total_s") for s in SPANS) / p["device_s"]
