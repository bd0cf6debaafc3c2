"""decode_step_ms.serve: the mean time of Model.decode_step, by the host clock
between synchronises, over the window's unprofiled batches."""


def read(run):
    spans = run.get("decode_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
