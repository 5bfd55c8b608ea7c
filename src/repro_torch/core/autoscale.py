"""Predictive pool autoscaling driven by the live metric event plane.

A copy of the JAX package's ``core/autoscale.py`` (pure Python and numpy, no
JAX): the port keeps its own so that it imports nothing from ``repro``.

The admission loop (``AdmissionSimulator.run``) publishes one window
summary per shard per metric window onto an :class:`~repro_torch.core.eventplane
.EventPlane`; the :class:`Autoscaler` here subscribes, forecasts demand,
and reconciles each shard's worker pool through an
:class:`AutoscaleActuator` — the mechanism half that issues the engine's
mid-run elasticity hooks (``schedule_worker_add`` / ``schedule_notice`` +
``schedule_worker_fail``).  Those are the *same* hooks the chaos tier
(``core.chaos``) compiles fault plans onto, so autoscaler actions and
injected faults interleave on one schedule, and every mutation marks the
owning shard dirty for the ShardCoordinator (§13).

Sizing brain (policy half, :class:`Autoscaler`):

* **reactive** — pure present-state feedback: each shard is sized to hold
  its *current* load (queued + busy tasks) at ``target_pressure``.
* **predictive** — the reactive floor plus an MPC-style horizon (Nguyen et
  al., PAPERS.md): cluster throughput is forecast by an EWMA with a linear
  trend term, per-request service time by a Welford estimator
  (:class:`~repro_torch.core.estimators.DurationEstimator`), and the pool is
  sized for the *worst* forecast window within ``horizon_windows`` via
  Little's law — capacity arrives before the burst does, not after.

Scale-down always goes through a **notice window** first
(``schedule_notice`` then ``schedule_worker_fail`` at ``t + notice_s``):
while the notice is open the worker is excluded from
``warm_capacity``/``warm_digest`` (the doomed-worker rule), so
admission and stealing stop routing work onto capacity about to retire.
A **scale-to-zero janitor** retires a shard's whole pool after
``idle_windows`` windows with no load, no outstanding work, and an empty
global queue (ColdBot-style); the admission tier's dead-shard salvage
drain re-homes any straggler VU, which is exactly the §10 machinery the
chaos tier already exercises.

Worker ids stay inside the static partition (``AdmissionSimulator``'s
merge remaps by fixed shard offsets): scale-up *revives* dead local ids,
never invents new ones.  Every decision is a pure function of the
published payload stream, so autoscaled runs are replayable bit-for-bit.
Contract: docs/ARCHITECTURE.md §14.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Set

from .estimators import DurationEstimator
from .eventplane import CLUSTER_TOPIC, EventPlane, MetricEvent, SHARD_TOPIC

__all__ = ["AutoscaleConfig", "AutoscaleAction", "AutoscaleActuator", "Autoscaler"]


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Sizing knobs (validated; frozen so a config can key caches).

    ``window_s`` must be a positive multiple of the admission tier's
    ``tick_s`` — the run loop publishes (and the autoscaler decides) only
    on tick boundaries.
    """

    mode: str = "predictive"  # "reactive" | "predictive"
    window_s: float = 1.0  # metric/decision window, seconds
    target_pressure: float = 0.7  # size pools to hold load at this pressure
    min_workers: int = 1  # per-shard floor while the shard has work
    initial_frac: float = 0.5  # fraction of each shard's span alive at t=0
    notice_s: float = 1.0  # scale-down drain notice before the kill
    horizon_windows: int = 3  # MPC lookahead (predictive mode)
    alpha: float = 0.5  # EWMA smoothing for the throughput forecast
    max_step: int = 4  # max workers added per shard per window
    down_step: int = 1  # max workers retired per shard per window
    down_after: int = 2  # consecutive excess windows before any retirement
    scale_to_zero: bool = True  # allow the janitor to empty idle shards
    idle_windows: int = 3  # idle windows before the janitor zeroes a shard

    def __post_init__(self):
        if self.mode not in ("reactive", "predictive"):
            raise ValueError(
                f"mode must be 'reactive' or 'predictive', got {self.mode!r}"
            )
        if self.window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")
        if not 0 < self.target_pressure <= 1:
            raise ValueError(
                f"target_pressure must be in (0, 1], got {self.target_pressure}"
            )
        if self.min_workers < 0:
            raise ValueError(f"min_workers must be >= 0, got {self.min_workers}")
        if not 0 < self.initial_frac <= 1:
            raise ValueError(
                f"initial_frac must be in (0, 1], got {self.initial_frac}"
            )
        if self.notice_s < 0:
            raise ValueError(f"notice_s must be >= 0, got {self.notice_s}")
        if self.horizon_windows < 1:
            raise ValueError(
                f"horizon_windows must be >= 1, got {self.horizon_windows}"
            )
        if not 0 < self.alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        if self.max_step < 1:
            raise ValueError(f"max_step must be >= 1, got {self.max_step}")
        if self.down_step < 1:
            raise ValueError(f"down_step must be >= 1, got {self.down_step}")
        if self.down_after < 1:
            raise ValueError(f"down_after must be >= 1, got {self.down_after}")
        if self.idle_windows < 1:
            raise ValueError(f"idle_windows must be >= 1, got {self.idle_windows}")


class AutoscaleAction(NamedTuple):
    """One issued pool mutation (telemetry; ``worker`` is the GLOBAL id)."""

    t: float  # decision time (the window boundary)
    kind: str  # "add" | "notice" | "fail"
    shard: int
    worker: int
    fire_t: float  # when the engine event fires (== t for adds)


class AutoscaleActuator:
    """Mechanism half: reconcile per-shard pool sizes onto engine hooks.

    Owns the only mutable coupling to the run — it is constructed by
    ``AdmissionSimulator.run`` with the live shard sims, the run's notice
    list (the policy-visible doomed-worker signal), and the run deadline.
    ``scale_to`` converges the shard toward ``target`` workers: scale-up
    revives dead local ids lowest-id-first, scale-down dooms live ids
    highest-id-first through a notice window.  Actions whose engine event
    would land at or past the deadline are dropped (they could never fire,
    and begin()-style validation would raise) — the run always terminates.
    """

    def __init__(
        self,
        sims: Sequence,
        worker_split: Sequence[int],
        worker_offsets: Sequence[int],
        notices: List,
        duration_s: float,
        notice_s: float,
    ):
        self.sims = list(sims)
        self.worker_split = list(worker_split)
        self.worker_offsets = list(worker_offsets)
        self._notices = notices  # shared with the admission loop: (t, k, until)
        self.duration_s = float(duration_s)
        self.notice_s = float(notice_s)
        self.actions: List[AutoscaleAction] = []
        self._pending_add: List[Set[int]] = [set() for _ in sims]
        self._doomed: List[Dict[int, float]] = [{} for _ in sims]

    def alive(self, k: int) -> int:
        return len(self.sims[k].workers)

    def planned(self, k: int, t: float) -> int:
        """Pool size shard ``k`` is converging to: live workers plus
        scheduled-but-unfired adds minus scheduled-but-unfired kills.
        Purges bookkeeping for events that already fired (or workers the
        chaos tier killed out from under us) as a side effect."""
        sim = self.sims[k]
        workers = sim.workers
        self._pending_add[k] = {w for w in self._pending_add[k] if w not in workers}
        self._doomed[k] = {
            w: tk for w, tk in self._doomed[k].items() if w in workers
        }
        return len(workers) + len(self._pending_add[k]) - len(self._doomed[k])

    def scale_to(self, t: float, k: int, target: int) -> int:
        """Issue the adds/dooms moving shard ``k`` toward ``target`` live
        workers.  Returns the signed number of actions issued."""
        span = self.worker_split[k]
        target = max(0, min(int(target), span))
        sim = self.sims[k]
        planned = self.planned(k, t)
        off = self.worker_offsets[k]
        if planned < target:
            need = target - planned
            if t >= self.duration_s:
                return 0  # an add at/past the deadline could never fire
            dead = [
                w for w in range(span)
                if w not in sim.workers and w not in self._pending_add[k]
            ]
            for w in dead[:need]:
                sim.schedule_worker_add(t, w)
                self._pending_add[k].add(w)
                self.actions.append(AutoscaleAction(t, "add", k, off + w, t))
            return min(need, len(dead))
        if planned > target:
            t_kill = t + self.notice_s
            if t_kill >= self.duration_s:
                return 0  # never doom capacity the run can't outlive
            excess = planned - target
            victims = [
                w for w in sorted(sim.workers, reverse=True)
                if w not in self._doomed[k]
            ]
            n = 0
            for w in victims[:excess]:
                sim.schedule_notice(t, w, t_kill)
                self._notices.append((t, k, t_kill))
                sim.schedule_worker_fail(t_kill, w)
                self._doomed[k][w] = t_kill
                self.actions.append(AutoscaleAction(t, "notice", k, off + w, t))
                self.actions.append(AutoscaleAction(t, "fail", k, off + w, t_kill))
                n += 1
            return -n
        return 0


class Autoscaler:
    """Policy half: subscribe to the event plane, forecast, pick targets.

    Pure function of the published payload stream: per-shard reactive
    loads come from the ``("shard", k)`` events, the cluster forecast
    state (EWMA throughput + trend, Welford service time) updates on the
    ``("cluster",)`` event — which the §14 publish order delivers *last*
    within a window, so decisions always see the complete window.
    """

    def __init__(self, cfg: Optional[AutoscaleConfig] = None):
        self.cfg = cfg or AutoscaleConfig()
        self.actuator: Optional[AutoscaleActuator] = None
        self.worker_split: List[int] = []
        self._est = DurationEstimator(prior_ms=200.0)
        self._rate: Optional[float] = None  # EWMA completions/s, cluster
        self._trend = 0.0  # smoothed d(rate)/window
        self._win: Dict[int, Mapping] = {}
        self._idle: List[int] = []
        self._excess: List[int] = []  # consecutive over-provisioned windows
        self.targets_log: List[List[int]] = []  # per decision window

    # ------------------------------------------------------------- wiring
    def initial_split(self, worker_split: Sequence[int]) -> List[int]:
        """Initial per-shard pool sizes: ``ceil(initial_frac * span)``,
        floored at ``min_workers`` (capped by the span)."""
        cfg = self.cfg
        return [
            min(n, max(math.ceil(cfg.initial_frac * n), cfg.min_workers))
            for n in worker_split
        ]

    def attach(
        self, bus: EventPlane, actuator: AutoscaleActuator,
        worker_split: Sequence[int],
    ) -> None:
        """Bind to a run: subscribe on ``bus`` (must be unsealed) and take
        the actuator the decisions drive.  One Autoscaler drives one run."""
        if self.actuator is not None:
            raise RuntimeError(
                "Autoscaler is already attached to a run; build a fresh one "
                "(forecast state is per-run)"
            )
        self.actuator = actuator
        self.worker_split = list(worker_split)
        self._idle = [0] * len(worker_split)
        self._excess = [0] * len(worker_split)
        bus.subscribe((SHARD_TOPIC, "*"), self._on_shard)
        bus.subscribe((CLUSTER_TOPIC,), self._on_cluster)

    # ------------------------------------------------------- subscribers
    def _on_shard(self, ev: MetricEvent) -> None:
        self._win[ev.topic[1]] = ev.payload

    def _on_cluster(self, ev: MetricEvent) -> None:
        cfg = self.cfg
        p = ev.payload
        # ---- forecast state update (estimators.py Welford + EWMA) ----
        n_done = int(p.get("n_done", 0))
        lam = n_done / cfg.window_s  # observed completions/s this window
        if self._rate is None:
            self._rate, self._trend = lam, 0.0
        else:
            prev = self._rate
            self._rate = cfg.alpha * lam + (1 - cfg.alpha) * prev
            self._trend = (
                cfg.alpha * (self._rate - prev) + (1 - cfg.alpha) * self._trend
            )
        for k in range(len(self.worker_split)):
            w = self._win.get(k)
            if w and w.get("n_done", 0):
                self._est.update(0, w["sum_ms"] / w["n_done"])
        if self.actuator is None:
            return  # observe-only (e.g. subscribed to a run_stream bus)
        t = ev.t_hi
        queue_depth = int(p.get("queue_depth", 0))
        targets = self._decide(t, queue_depth)
        self.targets_log.append(targets)
        for k, target in enumerate(targets):
            self.actuator.scale_to(t, k, target)

    # --------------------------------------------------------- decisions
    def _decide(self, t: float, queue_depth: int) -> List[int]:
        cfg = self.cfg
        split = self.worker_split
        total_span = sum(split)
        # predictive demand: worst forecast window within the horizon,
        # Little's law (busy workers = throughput x service time), sized to
        # run at target_pressure
        pred_busy = 0.0
        if cfg.mode == "predictive" and self._rate is not None:
            service_s = self._est.predict_ms(0) / 1e3
            lam_worst = max(
                self._rate + h * self._trend for h in range(1, cfg.horizon_windows + 1)
            )
            pred_busy = max(lam_worst, 0.0) * service_s
        targets = []
        for k, span in enumerate(split):
            w = self._win.get(k)
            load = int(w["load"]) if w else 0
            outstanding = int(w.get("outstanding", 0)) if w else 0
            # a share of the global admission queue is demand headed here
            load += int(math.ceil(queue_depth * span / max(total_span, 1)))
            react = math.ceil(load / cfg.target_pressure) if load else 0
            pred = (
                math.ceil(pred_busy * span / total_span / cfg.target_pressure)
                if pred_busy > 0
                else 0
            )
            target = max(react, pred)
            janitor = False
            if load or outstanding or queue_depth or target:
                self._idle[k] = 0
                target = max(target, cfg.min_workers)
            else:
                self._idle[k] += 1
                if cfg.scale_to_zero and self._idle[k] >= cfg.idle_windows:
                    janitor = True  # the pool has been cold long enough
                else:
                    target = max(target, cfg.min_workers)
            # asymmetric convergence: scale up fast (a burst under-served is
            # queueing now), scale down slowly and only on *sustained*
            # excess (retiring warmth on one quiet window churns cold
            # starts — the diurnal trough/crest cycle punishes eagerness).
            # The janitor sweep bypasses the ramp: a provably idle pool
            # retires whole, not one worker per window.
            planned = self.actuator.planned(k, t)
            if janitor:
                target = 0
            elif target < planned:
                self._excess[k] += 1
                if self._excess[k] < cfg.down_after:
                    target = planned  # hold until the excess persists
                else:
                    target = planned - min(cfg.down_step, planned - target)
            else:
                self._excess[k] = 0
                target = min(planned + min(cfg.max_step, target - planned), span)
            targets.append(max(0, min(target, span)))
        return targets
