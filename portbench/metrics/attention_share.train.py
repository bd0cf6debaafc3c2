"""attention_share.train: the device time charged to the program's
``block.attention`` spans (forward and the remat's recompute, whose launches
the spans hold), as a share (%) of all device-operation time in the traced
flow run (``portbench.harness.spans``)."""

from portbench.harness.spans import program_of, span_stat


def read(run):
    p = program_of(run)
    if not p or not p["device_s"]:
        return None
    return 100.0 * span_stat(p, "block.attention", "device_total_s") / p["device_s"]
