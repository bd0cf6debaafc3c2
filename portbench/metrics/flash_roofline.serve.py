"""flash_roofline.serve: the flash kernel's share (%) of its roofline in the
traced batches: the least time its launches could take
(portbench.harness.bounds, at each launch's padded shape), summed, over the
device time of the kernel's launches in the trace.  Nothing is read where no
flash kernel ran."""


def read(run):
    t = run.get("trace")
    if not t or not run.get("flash_bound_s"):
        return None
    spent = sum(s for name, s in t["by_name"].items() if "flash_attention" in name)
    return 100.0 * run["flash_bound_s"] / spent if spent > 0 else None
