"""mla_share.train: the device time charged to the program's
``block.attention`` spans (latent attention's forward, the remat's recompute
and the backward) as a share (%) of all device-operation time in the traced
flow run (``portbench.harness.spans``).  Nothing is read where no
``attention.mla`` span ran."""

from portbench.harness.spans import program_of, span_stat


def read(run):
    p = program_of(run)
    if not p or not p["device_s"] or not span_stat(p, "attention.mla", "count"):
        return None
    return 100.0 * span_stat(p, "block.attention", "device_total_s") / p["device_s"]
