"""train_tokens_per_s: every token trained in the window, the flow run in
flight at the close included, over the window's whole length (host clock)."""


def read(run):
    if "tokens" not in run or not run.get("window_s"):
        return None
    return run["tokens"] / run["window_s"]
