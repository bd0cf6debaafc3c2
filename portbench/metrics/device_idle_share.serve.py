"""device_idle_share.serve: the share (%) of the traced batches' host-clock
length in which no operation ran on the device: 1 - (union of the device
operations' intervals) / (window)."""


def read(run):
    t = run.get("trace")
    if not t or not t["window_s"] or not t["device_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
