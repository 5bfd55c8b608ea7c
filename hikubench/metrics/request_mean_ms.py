"""request_mean_ms: the mean latency of every window request, from its due
time to the return of ``submit``."""

import numpy as np


def read(run):
    return float(np.mean([(r.end_s - r.due_s) * 1e3 for r in run.requests]))
