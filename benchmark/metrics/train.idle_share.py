"""train.idle_share: the share of the traced steady steps in which no
operation ran on the card: 1 - device busy (the profiler's kernels and
copies, overlaps merged) over the traced window."""


def read(ctx, record):
    if "trace" not in record:
        return None
    tr = record["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
