"""cast_copy_share.serve: the device time of ``copy_kernel`` (the f32 <-> bf16
casts of weights, activations and gradients, and other copies) as a share (%)
of all device-operation time in the traced batches."""

from portbench.harness.trace import share_of


def read(run):
    return share_of(run.get("trace"), ("copy_kernel",))
