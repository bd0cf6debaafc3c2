"""serve_tokens_per_s: prompt tokens as sent (not padding) plus tokens
generated, of every request completed in the window, the batch in flight at
the close included, over the window's whole length (host clock)."""


def read(run):
    if "tokens" not in run or not run.get("window_s"):
        return None
    return run["tokens"] / run["window_s"]
