"""adamw_ms.train: the mean time of optimizer.adamw_update a step, by the host
clock between synchronises, over the window's unprofiled flow runs."""


def read(run):
    spans = run.get("adamw_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
