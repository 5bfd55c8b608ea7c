"""Pull-based scheduling on tensors (Algorithm 1 in array form).

The PyTorch counterpart of the JAX package's ``core/jax_sched.py``, with the
same semantics:

* ``idle[f, w]`` — multiset count of worker ``w``'s entries in ``PQ_f`` (one
  per enqueued idle instance).  Dequeuing the least-loaded member of ``PQ_f``
  is ``argmin_w(conns | idle[f, w] > 0)``.
* ``conns[w]`` — active connections (the priority key of Algorithm 1).

Events are ``(kind, func, worker)`` int32 triples:
  kind 0 = ARRIVAL(func)        -> (worker, warm); ``worker`` field is -1
  kind 1 = FINISH(func, worker) -> pull enqueue: ``idle[f, w] += 1``,
                                   ``conns[w] -= 1`` clamped at 0
  kind 2 = EVICT(func, worker)  -> ``idle[f, w] -= 1`` while it is above 0
  kind >= 3                     -> no-op padding event

Precondition: ``idle`` and ``conns`` start non-negative (``check_invariants``
checks it).  The reference clamps the *whole* arrays at 0 on every step while
this module and the CUDA kernel clamp only the cells an event touched; the
two agree exactly when the state starts non-negative.

Without a generator, ties go to the lowest index (``torch.argmin`` returns
the first minimum), which is what ``sched_many_fused`` and the CUDA kernel
reproduce bit for bit.  With a ``torch.Generator``, ties are broken uniformly
at random by the Gumbel-max trick, as the reference does with a PRNG key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .. import default_device

ARRIVAL, FINISH, EVICT = 0, 1, 2
_INF = 2**30


class JIQState(NamedTuple):
    """Scheduler state in array form: the whole of Algorithm 1's bookkeeping."""

    idle: torch.Tensor   # (F, W) int32 — PQ_f membership multiset
    conns: torch.Tensor  # (W,)  int32 — active connections


def init_state(n_funcs: int, n_workers: int, device=None) -> JIQState:
    """Empty state (no idle instances enqueued, zero connections) on
    ``device`` (the card unless ``device="cpu"``)."""
    device = default_device(device)
    return JIQState(
        idle=torch.zeros((n_funcs, n_workers), dtype=torch.int32, device=device),
        conns=torch.zeros((n_workers,), dtype=torch.int32, device=device),
    )


def _tie_break_argmin(scores: torch.Tensor, generator: Optional[torch.Generator]) -> int:
    """argmin with the lowest index winning ties, or with a uniform random
    choice among exact ties (Gumbel-max) when a generator is given."""
    if generator is None:
        return int(scores.argmin())
    tied = scores == scores.min()
    e = torch.empty(scores.shape, dtype=torch.float32, device=scores.device)
    gumbel = -e.exponential_(generator=generator).log()
    return int(torch.where(tied, gumbel, float("-inf")).argmax())


def _step(idle: torch.Tensor, conns: torch.Tensor, kind: int, func: int, worker: int,
          generator: Optional[torch.Generator]) -> Tuple[int, bool]:
    """Apply one event to ``idle``/``conns`` in place; return (worker, warm)."""
    if kind == ARRIVAL:
        live = idle[func] > 0
        has_idle = bool(live.any())
        if has_idle:  # pull: dequeue the least-loaded enqueued worker
            w = _tie_break_argmin(torch.where(live, conns, _INF), generator)
            idle[func, w] -= 1
        else:  # fallback: least connections
            w = _tie_break_argmin(conns, generator)
        conns[w] += 1
        return w, has_idle
    if kind == FINISH:
        idle[func, worker] += 1
        conns[worker] = (conns[worker] - 1).clamp_min(0)
    elif kind == EVICT:
        idle[func, worker] -= (idle[func, worker] > 0).to(idle.dtype)
    return -1, False


def sched_step(
    state: JIQState, event: Sequence[int], generator: Optional[torch.Generator] = None
) -> Tuple[JIQState, Tuple[int, bool]]:
    """One event transition.  Returns (state', (worker, warm)); for FINISH,
    EVICT and padding events the assignment is (-1, False).  ``state`` is
    left untouched."""
    idle, conns = state.idle.clone(), state.conns.clone()
    kind, func, worker = (int(v) for v in event)
    out = _step(idle, conns, kind, func, worker, generator)
    return JIQState(idle, conns), out


def sched_many(
    state: JIQState, events: torch.Tensor, generator: Optional[torch.Generator] = None
) -> Tuple[JIQState, Tuple[torch.Tensor, torch.Tensor]]:
    """Step an (N, 3) int32 event stream one event at a time (the plain scan).

    Runs on the device of ``state``; ``state`` is left untouched.  Returns
    (state', (workers (N,) int32, warm (N,) bool)).  With a ``generator``
    (on the state's device) ties are broken at random.
    """
    idle, conns = state.idle.clone(), state.conns.clone()
    ws, warms = [], []
    for kind, func, worker in events.tolist():
        w, warm = _step(idle, conns, kind, func, worker, generator)
        ws.append(w)
        warms.append(warm)
    return JIQState(idle, conns), (
        torch.tensor(ws, dtype=torch.int32, device=idle.device),
        torch.tensor(warms, dtype=torch.bool, device=idle.device),
    )


def sched_many_fused(
    state: JIQState,
    events: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    chunk: int = 1024,
    device=None,
) -> Tuple[JIQState, Tuple[torch.Tensor, torch.Tensor]]:
    """``sched_many`` with the stream cut into ``chunk``-event bursts, each
    one call of ``kernels.ops.sched_events`` (``ops.sched_step``, its
    ARRIVAL-only specialisation, for a burst of arrivals only): one kernel
    launch on the card, the plain version on the CPU.  Bitwise equal to
    ``sched_many(state, events)``.

    State and events are moved to ``device`` (the card unless
    ``device="cpu"``).  With a ``generator`` (randomised ties live in the
    plain scan) the whole stream goes through ``sched_many``.  The ragged
    last chunk is launched at its own length: a launch takes any burst size,
    so no padding events are needed.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    device = default_device(device)
    state = JIQState(state.idle.to(device), state.conns.to(device))
    kinds = events[:, 0].to("cpu")  # taken before the move: free for host events
    events = events.to(device=device, dtype=torch.int32)
    if generator is not None:
        return sched_many(state, events, generator)
    return _fused(state, events, kinds, chunk, device)


def _fused(state: JIQState, events: torch.Tensor, kinds: torch.Tensor, chunk: int, device):
    """The burst loop of ``sched_many_fused``: ``events`` on ``device``,
    ``kinds`` (its first column) on the host, where it picks each chunk's
    specialisation without a copy back from the card."""
    from ..kernels import ops  # deferred: kernels import this module

    idle, conns = state
    ws, warms = [], []
    for lo in range(0, events.shape[0], chunk):
        ev = events[lo: lo + chunk]
        if bool((kinds[lo: lo + chunk] == ARRIVAL).all()):  # an arrival burst
            a, warm, idle, conns = ops.sched_step(ev[:, 1], idle, conns)
        else:  # the columns as strided views: the kernel reads them in place
            a, warm, idle, conns = ops.sched_events(ev[:, 0], ev[:, 1], ev[:, 2], idle, conns)
        ws.append(a)
        warms.append(warm)
    return JIQState(idle, conns), _cat(ws, warms, device)


def sched_many_adaptive(
    state: JIQState,
    events: torch.Tensor,
    detector: "BurstDetector",
    densities=None,
    segment: int = 1024,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[JIQState, Tuple[torch.Tensor, torch.Tensor]]:
    """Burst-adaptive dispatch: walk the stream in ``segment``-event windows
    and let ``detector`` pick each window's chunk size.

    Before each window one density sample is folded into the detector
    (``densities[i]`` when given, else the window's own event count).  A
    chunk of 1 steps the window through ``sched_many``; a larger one fuses it
    through ``sched_many_fused``.  Both routes are bitwise equal by contract,
    so this is a dispatch choice: the result equals ``sched_many(state,
    events)`` for every detector state and density sequence.  With a
    ``generator`` the whole stream goes through ``sched_many``.
    """
    if segment < 1:
        raise ValueError(f"segment must be >= 1, got {segment}")
    device = default_device(device)
    state = JIQState(state.idle.to(device), state.conns.to(device))
    kinds = events[:, 0].to("cpu")
    events = events.to(device=device, dtype=torch.int32)
    if generator is not None:
        return sched_many(state, events, generator)
    n = events.shape[0]
    n_windows = -(-n // segment)
    if densities is not None and len(densities) < n_windows:
        raise ValueError(f"densities has {len(densities)} samples for {n_windows} windows")
    ws, warms = [], []
    for i in range(n_windows):
        win = slice(i * segment, (i + 1) * segment)
        ev = events[win]
        sample = float(densities[i]) if densities is not None else float(ev.shape[0])
        chunk = detector.observe(sample)
        if chunk <= 1:
            state, (a, warm) = sched_many(state, ev)
        else:
            state, (a, warm) = _fused(state, ev, kinds[win], chunk, device)
        ws.append(a)
        warms.append(warm)
    return state, _cat(ws, warms, device)


def _cat(ws, warms, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Join per-chunk (workers, warm) outputs; empty streams give empty tensors."""
    if not ws:
        return (torch.zeros((0,), dtype=torch.int32, device=device),
                torch.zeros((0,), dtype=torch.bool, device=device))
    return torch.cat(ws), torch.cat(warms).bool()


def check_invariants(state: JIQState) -> bool:
    """The structural invariant (and the precondition of every path here):
    ``idle`` and ``conns`` are non-negative."""
    return bool((state.idle >= 0).all()) and bool((state.conns >= 0).all())


class BurstDetector:
    """EWMA + threshold burst detector over near-horizon event density.

    A copy of the JAX package's ``core/simulator.py::BurstDetector``.  Callers
    feed it the event density ahead of the clock and it answers with a
    dispatch chunk size: a smoothed density above a threshold selects that
    threshold's chunk (largest first); below every threshold it falls back to
    ``base_chunk`` (1 = single-event stepping).  The EWMA (``ewma += alpha *
    (density - ewma)``; the first observation primes it) makes the choice
    hysteretic.  A pure observer: it never touches event order.

    Args:
        alpha: EWMA smoothing factor in (0, 1].
        thresholds: ``((density, chunk), ...)`` sorted descending by density;
            the first row whose density the EWMA meets wins.
        base_chunk: chunk when the EWMA is below every threshold.
    """

    __slots__ = ("alpha", "thresholds", "base_chunk", "ewma", "_primed")

    def __init__(
        self,
        alpha: float = 0.25,
        thresholds: Tuple[Tuple[float, int], ...] = ((4096.0, 4096), (1024.0, 1024), (256.0, 256)),
        base_chunk: int = 1,
    ):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if base_chunk < 1:
            raise ValueError(f"base_chunk must be >= 1, got {base_chunk}")
        rows = tuple((float(d), int(c)) for d, c in thresholds)
        if any(c < 1 for _, c in rows):
            raise ValueError(f"chunk sizes must be >= 1, got {rows}")
        if list(rows) != sorted(rows, reverse=True):
            raise ValueError(f"thresholds must be sorted descending, got {rows}")
        self.alpha = alpha
        self.thresholds = rows
        self.base_chunk = int(base_chunk)
        self.ewma = 0.0
        self._primed = False

    def observe(self, density: float) -> int:
        """Fold one density sample in; return the chunk size to use now."""
        density = float(density)
        if not self._primed:
            self.ewma = density
            self._primed = True
        else:
            self.ewma += self.alpha * (density - self.ewma)
        return self.chunk

    @property
    def chunk(self) -> int:
        """Current chunk choice for the smoothed density (no fold)."""
        for thresh, chunk in self.thresholds:
            if self.ewma >= thresh:
                return chunk
        return self.base_chunk
