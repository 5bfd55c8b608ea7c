"""load_cv: the paper's load imbalance, the coefficient of variation across
workers of the requests assigned to each in one second, averaged over the
seconds in which any was assigned (the arithmetic of the port's
``core/metrics.py::load_cv_per_second``), over the whole window."""

import numpy as np


def read(run):
    n_w = run.workers
    t = np.array([r.start_s for r in run.requests])
    w = np.array([r.worker for r in run.requests])
    n_bins = int(np.ceil(max(t.max(initial=0.0), run.seconds))) + 1
    counts = np.bincount(np.minimum(t.astype(np.int64), n_bins - 1) * n_w + w,
                         minlength=n_bins * n_w).reshape(n_bins, n_w).astype(np.float64)
    counts = counts[counts.sum(axis=1) > 0]
    if not len(counts):
        return None
    mean, std = counts.mean(axis=1), counts.std(axis=1)
    return float(np.where(mean > 0, std / np.maximum(mean, 1e-12), 0.0).mean())
