"""edit_p95_ms: the 95th percentile of seed-edit latency over every
request due in the window, each timed by the host's clock from its due
time to its answer; a request that failed or never answered reads as
infinitely late."""

import numpy as np


def read(ctx, record):
    if "latencies_ms" not in record:
        return None
    return float(np.percentile(record["latencies_ms"], 95))
