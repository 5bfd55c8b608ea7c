"""The program's own records of a run's requests: the spans and device
intervals that ``repro_torch.serving.telemetry`` keeps, one record a
request, in its ring.

The window's requests are the last ones the program served before the
metrics are read, so the ring's last ``len(run.requests)`` records are
theirs, in order; each is held to its ``Served`` entry's worker and
cold/warm outcome.  Where the program keeps no such records (a tree
without the module), holds fewer, or any one does not match, every
reader here gives None.
"""

from typing import List, Optional

import numpy as np


def window_records(run) -> Optional[List]:
    """The program's record of each of the window's requests, in order, or
    None."""
    try:
        from repro_torch.serving import telemetry
    except ImportError:
        return None
    n = len(run.requests)
    ring = list(telemetry.RING)
    if not n or len(ring) < n:
        return None
    recs = ring[-n:]
    if any(rec.worker != r.worker or rec.cold != r.cold for r, rec in zip(run.requests, recs)):
        return None
    return recs


def untraced(run, cold: bool) -> Optional[List]:
    """The records of the cold (or warm) requests served with the profiler
    off, or None."""
    recs = window_records(run)
    if recs is None:
        return None
    return [rec for r, rec in zip(run.requests, recs) if not r.traced and r.cold == cold]


def traced_spans_s(run, name: str, cold: bool) -> Optional[List]:
    """(start, end) in seconds, the profiler's clock, of the ``name`` spans
    of the cold (or warm) requests served with the profiler on, or None."""
    recs = window_records(run)
    if recs is None:
        return None
    return [(s * 1e-9, t * 1e-9) for r, rec in zip(run.requests, recs)
            if r.traced and r.cold == cold for n, s, t in rec.spans if n == name]


def mean(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return float(np.mean(values)) if values else None
