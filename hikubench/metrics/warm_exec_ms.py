"""warm_exec_ms: the instance layer's execution, the mean ``exec_ms`` (the
prefill and the decode replays, ending in a synchronize) of the warm
requests served with the profiler off."""

import numpy as np


def read(run):
    rs = [r for r in run.untraced() if not r.cold]
    return float(np.mean([r.exec_ms for r in rs])) if rs else None
