"""Record-then-replay for admission runs: scripted per-shard re-execution.

A copy of the JAX package's ``core/replay.py`` (pure Python and numpy, no
JAX): the port keeps its own so that it imports nothing from ``repro``.

Learned policies put run history into the decision path, so "the run is
deterministic" needs teeth beyond re-running the whole admission loop: this
module re-executes a *recorded* admission run shard by shard, from nothing
but each shard's admission table, and demands byte-identical record streams.

Why that is a meaningful check: under a steal-free, salvage-free admission
run, a shard's entire evolution is determined by its seed, its config, and
the ``(time, program)`` sequence of VUs admitted into it — the policy (with
all its learned state) influenced *which* VUs bound *when*, and nothing
else.  :func:`scripts_from_run` extracts exactly that interface
(:class:`ShardScript`, picklable), and :func:`replay_shards` re-runs the
scripts on any of the three shard execution styles:

* ``serial`` — one shard after another in this process;
* ``interleaved`` — all shards round-robined tick by tick in this process
  (the lockstep shape of the admission co-run itself);
* ``process`` — one OS process per shard (fork-based pool, same idiom as
  ``core.shard``).

All three must reproduce each recorded shard's ``RequestRecord`` stream and
assignment trace **byte-for-byte** (``tests/test_replay.py`` pins it, for
learned policies recorded via ``policy_args={"record_state": True}`` whose
estimator snapshots replay through ``replay_from`` — the two halves of the
record-then-replay contract in docs/POLICIES.md "Learned state").

Runs with cross-shard identity moves (steals, dead-shard salvage) are *not*
scriptable per shard — a migrated VU's service identity spans two engines —
so :func:`scripts_from_run` refuses them loudly.  Engine-local faults
(worker kills/revivals/notices) replay fine: the schedule rides on the
script.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import warnings
from concurrent.futures import ProcessPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .records import RecordColumns
from .scheduler import make_scheduler
from .shard import shard_seed
from .simulator import SimConfig, Simulator
from .trace import VUProgram, make_functions

__all__ = [
    "REPLAY_BACKENDS",
    "ShardScript",
    "ScriptResult",
    "replay_shards",
    "run_script",
    "scripts_from_run",
]

REPLAY_BACKENDS = ("serial", "interleaved", "process")


@dataclasses.dataclass
class ShardScript:
    """Everything one shard needs to re-run a recorded admission run
    (picklable, so the ``process`` backend can ship it to a child).

    ``admits`` is the shard's recorded admission schedule — ``(t, program)``
    in admission order, times on the admission tick grid.  ``funcs_seed``
    regenerates the *shared* function population (``make_functions``): under
    global admission every shard serves the same functions, unlike the
    static partition's per-shard populations.  Fault events carry
    shard-local worker ids.
    """

    index: int
    seed: int  # shard_seed(run_seed, index) — the engine identity
    scheduler: str
    cfg: SimConfig  # n_workers already rewritten to the shard's split
    funcs_seed: int
    duration_s: float
    tick_s: float
    admits: Tuple[Tuple[float, VUProgram], ...]
    failures: Tuple[Tuple[float, int], ...] = ()
    additions: Tuple[Tuple[float, int], ...] = ()
    notices: Tuple[Tuple[float, int, float], ...] = ()


@dataclasses.dataclass
class ScriptResult:
    """One replayed shard's output, in shard-local ids — directly
    comparable against the recorded ``AdmissionShard``."""

    index: int
    records: RecordColumns
    assign_t: np.ndarray
    assign_w: np.ndarray
    n_events: int

    def matches(self, shard) -> bool:
        """Byte-identical to a recorded ``AdmissionShard``?"""
        return bool(
            self.records.equals(shard.records)
            and np.array_equal(self.assign_t, shard.assign_t)
            and np.array_equal(self.assign_w, shard.assign_w)
        )


def scripts_from_run(adm, run, programs, duration_s: float) -> List[ShardScript]:
    """Extract per-shard replay scripts from a recorded admission run.

    Args:
        adm: the ``AdmissionSimulator`` that produced ``run`` (source of
            seeds, partition, scheduler, config and any injected fault
            schedule).
        run: the ``AdmissionRun`` to replay.  Must be steal- and
            salvage-free — cross-shard identity moves cannot be replayed
            shard-locally, and the refusal is loud.
        programs: the global VU programs the run was driven with.
        duration_s: the recorded run's deadline (not stored on the run).
    """
    if run.n_migrations or run.n_salvages:
        raise ValueError(
            f"run has {run.n_migrations} migrations and {run.n_salvages} "
            "salvages — a VU whose service identity moved between shards "
            "cannot be replayed shard-locally; record with a steal-free "
            "policy and no dead-shard drain to script the run"
        )
    per_failures: List[List[Tuple[float, int]]] = [[] for _ in range(adm.n_shards)]
    per_additions: List[List[Tuple[float, int]]] = [[] for _ in range(adm.n_shards)]
    per_notices: List[List[Tuple[float, int, float]]] = [
        [] for _ in range(adm.n_shards)
    ]
    for ft, gw in adm._failures:
        k, local = adm._locate(gw, "scripts_from_run")
        per_failures[k].append((ft, local))
    for ft, gw in adm._additions:
        k, local = adm._locate(gw, "scripts_from_run")
        per_additions[k].append((ft, local))
    for ft, gw, until in adm._notices:
        k, local = adm._locate(gw, "scripts_from_run")
        per_notices[k].append((ft, local, until))
    scripts = []
    for k, shard in enumerate(run.shards):
        admits = tuple(
            (float(t), programs[int(gid)])
            for t, gid in zip(shard.admit_t, shard.admitted)
        )
        scripts.append(
            ShardScript(
                index=k,
                seed=shard_seed(adm.seed, k),
                scheduler=adm.scheduler,
                cfg=dataclasses.replace(adm.cfg, n_workers=adm.worker_split[k]),
                funcs_seed=adm.seed,
                duration_s=float(duration_s),
                tick_s=float(adm.admission.tick_s),
                admits=admits,
                failures=tuple(per_failures[k]),
                additions=tuple(per_additions[k]),
                notices=tuple(per_notices[k]),
            )
        )
    return scripts


def _script_steps(script: ShardScript) -> Iterator[Optional[ScriptResult]]:
    """Generator form of one shard's replay: yields ``None`` once per
    admission tick (the interleave points), then the :class:`ScriptResult`.

    Stepping on the recorded tick grid reproduces the admission co-run's
    engine calls exactly: admissions land at their recorded boundary times
    (bit-equal floats — both sides compute ``tick * tick_s``), and event
    processing order inside the engine depends only on the event heap, not
    on the step granularity.
    """
    funcs = make_functions(seed=script.funcs_seed)
    sched = make_scheduler(
        script.scheduler, script.cfg.n_workers, seed=script.seed
    )
    sim = Simulator(sched, funcs=funcs, cfg=script.cfg, seed=script.seed)
    for ft, w in script.failures:
        sim.inject_failure(ft, w)
    for ft, w in script.additions:
        sim.inject_worker(ft, w)
    for ft, w, until in script.notices:
        sim.inject_notice(ft, w, until)
    sim.begin(n_vus=0, duration_s=script.duration_s, programs=[])
    admits = script.admits
    i = 0
    tick = 0
    t = 0.0
    while True:
        while i < len(admits) and admits[i][0] <= t:
            sim.admit_vu(admits[i][1], t=t)
            i += 1
        if t >= script.duration_s and sim.done and i == len(admits):
            break
        tick += 1
        t = tick * script.tick_s  # drift-free, like the admission loop
        sim.step_until(t)
        yield None
    at, aw = sim.assignment_columns
    yield ScriptResult(
        index=script.index,
        records=sim.record_columns,
        assign_t=at,
        assign_w=aw,
        n_events=sim.n_events,
    )


def run_script(script: ShardScript) -> ScriptResult:
    """Replay one shard's script to completion (the ``serial``/``process``
    unit of work; module-level, hence picklable)."""
    result = None
    for result in _script_steps(script):
        pass
    return result


def _run_interleaved(scripts: Sequence[ShardScript]) -> List[ScriptResult]:
    """Round-robin all shard replays tick by tick in this process — the
    lockstep shape of the admission co-run itself."""
    gens = [_script_steps(s) for s in scripts]
    results: List[Optional[ScriptResult]] = [None] * len(scripts)
    live = list(range(len(scripts)))
    while live:
        still = []
        for i in live:
            step = next(gens[i])
            if step is None:
                still.append(i)
            else:
                results[i] = step
        live = still
    return results  # type: ignore[return-value]


def _run_process_pool(scripts: Sequence[ShardScript]) -> List[ScriptResult]:
    # same fork-first idiom as core.shard: replay children are pure
    # numpy/heapq and never touch torch or a device, so the fork warning
    # is suppressed; REPRO_SHARD_START_METHOD overrides where fork is not viable
    start = os.environ.get("REPRO_SHARD_START_METHOD") or (
        "fork" if "fork" in mp.get_all_start_methods() else "spawn"
    )
    ctx = mp.get_context(start)
    max_workers = min(len(scripts), os.cpu_count() or 1)
    with warnings.catch_warnings():
        if start == "fork":
            warnings.filterwarnings(
                "ignore", message=r"os\.fork\(\) was called", category=RuntimeWarning
            )
        with ProcessPoolExecutor(max_workers=max_workers, mp_context=ctx) as pool:
            return list(pool.map(run_script, scripts))


def replay_shards(
    scripts: Sequence[ShardScript], backend: str = "serial"
) -> List[ScriptResult]:
    """Replay shard scripts on one of the three backends (shard order
    preserved; identical results on all three by the determinism contract)."""
    if backend == "serial":
        return [run_script(s) for s in scripts]
    if backend == "interleaved":
        return _run_interleaved(scripts)
    if backend == "process":
        return _run_process_pool(scripts)
    raise ValueError(
        f"unknown replay backend {backend!r}; available: {REPLAY_BACKENDS}"
    )
