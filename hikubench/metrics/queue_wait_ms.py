"""queue_wait_ms: the open-loop client's lateness, the mean of due time to
``submit`` called, over the requests served with the profiler off."""

import numpy as np


def read(run):
    rs = run.untraced()
    return float(np.mean([(r.start_s - r.due_s) * 1e3 for r in rs])) if rs else None
