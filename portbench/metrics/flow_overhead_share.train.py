"""flow_overhead_share.train: the share (%) of the window's unprofiled flow
runs spent outside the registered train_steps (the control plane: publishing
the run, the engine's dispatch and completion), by the harness's host-clock
spans around train_steps."""


def read(run):
    if not run.get("steady_s") or "steady_span_s" not in run:
        return None
    return 100.0 * (run["steady_s"] - run["steady_span_s"]) / run["steady_s"]
