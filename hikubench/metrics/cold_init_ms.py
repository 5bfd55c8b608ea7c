"""cold_init_ms: the worker layer's cold start, the mean ``init_ms`` of the
cold requests served with the profiler off (the eviction, the weights made
on the card and the decode step's capture)."""

import numpy as np


def read(run):
    rs = [r for r in run.untraced() if r.cold]
    return float(np.mean([r.init_ms for r in rs])) if rs else None
