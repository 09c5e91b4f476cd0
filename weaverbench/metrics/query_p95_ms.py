"""The 95th percentile of the latency of every query completed in the
window, call to answer on the card (host clock)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3
