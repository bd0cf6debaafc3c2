"""step_mfu.serve: model FLOPs of the requests served in the window's
unprofiled batches (portbench.harness.flops: prompts without padding, decode
steps over each request's own tokens) over their host-clock time, as a share
(%) of the H100's bf16 peak."""

from portbench.harness.peaks import PEAK_FLOPS


def read(run):
    if not run.get("steady_s") or not run.get("model_flops_steady"):
        return None
    return 100.0 * run["model_flops_steady"] / run["steady_s"] / PEAK_FLOPS["bfloat16"]
