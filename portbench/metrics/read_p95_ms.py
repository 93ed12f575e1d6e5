"""95th percentile of every read of the window, call to synchronise."""

import numpy as np


def read(m):
    if m["op"] != "read" or not m["latencies_s"]:
        return None
    return float(np.percentile(m["latencies_s"], 95)) * 1e3
