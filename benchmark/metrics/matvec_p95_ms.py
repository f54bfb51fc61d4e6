"""95th percentile of the latency of every product of the window, from
its issue to the end of its synchronize (host clock)."""

import numpy as np


def read(rec):
    if rec.kind != "matvec" or not rec.count:
        return None
    return float(np.percentile(rec.latencies_s(), 95)) * 1e3
