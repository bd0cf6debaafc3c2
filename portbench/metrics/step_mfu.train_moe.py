"""step_mfu.train_moe: model FLOPs of a latent-attention MoE model's steps done
in the window's unprofiled flow runs (portbench.harness.flops_mla_moe) over
their host-clock time, as a share (%) of the H100's bf16 peak."""

from portbench.harness.peaks import PEAK_FLOPS


def read(run):
    if not run.get("steady_s") or not run.get("mla_moe_flops_steady"):
        return None
    return 100.0 * run["mla_moe_flops_steady"] / run["steady_s"] / PEAK_FLOPS["bfloat16"]
