"""setup_s: seconds from the process's start to the window's (host clock)."""


def read(run):
    return run.get("setup_s")
