"""request_p90_ms: the 90th percentile (linear between order statistics) of
every window request's latency, from its due time to the return of
``submit``."""

import numpy as np


def read(run):
    return float(np.percentile([(r.end_s - r.due_s) * 1e3 for r in run.requests], 90))
