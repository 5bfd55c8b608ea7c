"""sched_us: the scheduler's decision time a request, the mean of the
engine's ``sched_overhead_ms`` (host clock around ``schedule``) in us, over
the requests served with the profiler off."""

import numpy as np


def read(run):
    rs = run.untraced()
    return float(np.mean([r.sched_ms for r in rs]) * 1e3) if rs else None
