"""Reading a ``torch.profiler`` run: the device's operations and the spans
the harness records around its calls into the program, on one timeline.

The harness names its spans ``hikubench.<layer>`` (``record_function``);
the profiler puts them and the card's operations (kernels, copies, sets,
those of CUDA graph replays included) on the same clock.  Everything here
works on plain (name, start, end) tuples in seconds, so the arithmetic is
tested without a card.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]
SPAN_PREFIX = "hikubench."


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, float, float]]     # the device's operations
    spans: List[Tuple[str, float, float]]   # the harness's spans, prefix removed
    window: Interval                        # the traced window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def from_profiler(prof, window: Interval) -> Trace:
    """The device operations and harness spans of a stopped
    ``torch.profiler.profile``; ``window`` is the traced window on the
    profiler's clock (seconds), taken from two spans the harness opened at
    its ends."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        name = e.name()
        if name.startswith(SPAN_PREFIX):  # the profiler mirrors each span on the device too
            if e.device_type() != DeviceType.CUDA:
                spans.append((name[len(SPAN_PREFIX):], s, t))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ops.append((name, s, t))
    return Trace(ops, spans, window)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for s, t in sorted(intervals):
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def length(intervals: Sequence[Interval]) -> float:
    return sum(t - s for s, t in intervals)


def intersect(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, t = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < t:
            out.append((s, t))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def span_intervals(tr: Trace, name: str) -> List[Interval]:
    return union((s, t) for n, s, t in tr.spans if n == name)


def busy(tr: Trace, within: Optional[Sequence[Interval]] = None) -> float:
    """Seconds in which some operation ran on the device, inside ``within``
    (the traced window unless given)."""
    dev = union((s, t) for _, s, t in tr.ops)
    return length(intersect(dev, within if within is not None else [tr.window]))


def idle_share(tr: Trace, spans: Sequence[Interval]) -> Optional[float]:
    """The share of the union of ``spans`` in which no operation ran on the
    device; None where the spans cover nothing."""
    u = union(spans)
    total = length(u)
    if total <= 0:
        return None
    return 1.0 - busy(tr, u) / total


def kernel_seconds(tr: Trace, pattern: str, within: Sequence[Interval]) -> Tuple[float, int]:
    """Summed device time and count of the operations whose name matches
    ``pattern`` and that start inside ``within``."""
    rx = re.compile(pattern)
    win = union(within)
    total, n = 0.0, 0
    for name, s, t in tr.ops:
        if rx.search(name) and any(a <= s < b for a, b in win):
            total += t - s
            n += 1
    return total, n


def short_name(name: str) -> str:
    """An operation's name without its template and function arguments and
    its return type, at most 96 characters (a copy or a set: its first two
    words)."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    base, prev = name, None
    while base != prev:  # drop the innermost <...> and (...) groups until none is left
        prev, base = base, re.sub(r"<[^<>]*>|\([^()]*\)", "", base)
    words = base.split()
    return (words[-1] if words else name)[:96]


def top_ops(tr: Trace, k: int = 10) -> List[List]:
    """The ``k`` device operations that took most time in the window, by
    name."""
    by: Dict[str, float] = {}
    for name, s, t in tr.ops:
        if tr.window[0] <= s < tr.window[1]:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + (t - s)
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(tr: Trace, k: int = 10) -> List[List]:
    """The device's idle time in the window, summed by what the host was
    doing: each idle stretch, cut at the harness spans' ends, goes to the
    innermost span open over it (``outside`` where none was); the ``k``
    largest."""
    import numpy as np

    dev = union((s, t) for _, s, t in tr.ops)
    w0, w1 = tr.window
    gaps, at = [], w0
    for s, t in intersect(dev, [tr.window]):
        if s > at:
            gaps.append((at, s))
        at = t
    if at < w1:
        gaps.append((at, w1))
    names = [n for n, _, _ in tr.spans]
    a = np.array([s for _, s, _ in tr.spans], dtype=np.float64)
    b = np.array([t for _, _, t in tr.spans], dtype=np.float64)
    by: Dict[str, float] = {}
    for s, t in gaps:
        over = np.flatnonzero((a < t) & (b > s))
        cuts = sorted({s, t, *(x for x in np.concatenate([a[over], b[over]]) if s < x < t)})
        for lo, hi in zip(cuts, cuts[1:]):
            mid = 0.5 * (lo + hi)
            inner = [(b[i] - a[i], names[i]) for i in over if a[i] <= mid < b[i]]
            key = min(inner)[1] if inner else "outside"
            by[key] = by.get(key, 0.0) + (hi - lo)
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
