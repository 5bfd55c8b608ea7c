"""Serverless serving engine: scheduler + worker hosts + endpoints
(counterpart of the JAX package's ``serving/engine.py``).

Requests for a function type arrive, the pluggable scheduler picks a worker,
the worker executes (cold start = parameter materialisation + warm-up, warm =
instance reuse), completion triggers the pull-enqueue, evictions trigger the
notification mechanism.  All workers share one device: the card unless
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import default_device
from ..core.scheduler import Scheduler, make_scheduler
from .worker import Endpoint, ExecutionRecord, WorkerHost


@dataclasses.dataclass
class RequestResult:
    func: str
    worker: int
    cold: bool
    latency_ms: float
    sched_overhead_ms: float


class ServingEngine:
    def __init__(
        self,
        endpoints: Sequence[Endpoint],
        n_workers: int = 2,
        scheduler: str | Scheduler = "hiku",
        mem_pool_bytes: int = 2 * 2**30,
        keep_alive_s: float = 60.0,
        seed: int = 0,
        device=None,
    ):
        self.device = default_device(device)
        self.endpoints: Dict[str, Endpoint] = {e.name: e for e in endpoints}
        self.workers = {
            w: WorkerHost(w, mem_pool_bytes, keep_alive_s, self.device) for w in range(n_workers)
        }
        self.sched = (
            scheduler
            if isinstance(scheduler, Scheduler)
            else make_scheduler(scheduler, n_workers, seed=seed)
        )
        for w in self.workers.values():
            w.on_evict = self.sched.on_evict
        self.records: List[RequestResult] = []

    def submit(self, func: str, tokens: Optional[torch.Tensor] = None,
               gen_len: int = 2) -> RequestResult:
        ep = self.endpoints[func]
        if tokens is None:
            tokens = torch.ones((1, 8), dtype=torch.int32)
        t0 = time.perf_counter()
        w = self.sched.schedule(func)
        t_sched = (time.perf_counter() - t0) * 1e3
        rec: ExecutionRecord = self.workers[w].execute(ep, tokens, gen_len)
        self.sched.on_finish(w, func)
        out = RequestResult(
            func=func, worker=w, cold=rec.cold,
            latency_ms=rec.total_ms, sched_overhead_ms=t_sched,
        )
        self.records.append(out)
        return out

    def sweep(self) -> None:
        for w in self.workers.values():
            w.sweep()

    # ------------------------------------------------------------- faults
    def fail_worker(self, wid: int) -> None:
        """Simulate node failure: drop all instances, deregister from scheduler."""
        w = self.workers.pop(wid, None)
        if w is not None:
            self.sched.on_worker_removed(wid)

    def add_worker(self, wid: int, mem_pool_bytes: int = 2 * 2**30,
                   keep_alive_s: float = 60.0) -> None:
        host = WorkerHost(wid, mem_pool_bytes, keep_alive_s, self.device)
        host.on_evict = self.sched.on_evict
        self.workers[wid] = host
        self.sched.on_worker_added(wid)

    # ------------------------------------------------------------ metrics
    def summary(self) -> Dict[str, float]:
        lat = np.array([r.latency_ms for r in self.records]) if self.records else np.zeros(1)
        cold = np.array([r.cold for r in self.records]) if self.records else np.zeros(1)
        ov = np.array([r.sched_overhead_ms for r in self.records]) if self.records else np.zeros(1)
        return {
            "n": len(self.records),
            "mean_latency_ms": float(lat.mean()),
            "cold_rate": float(cold.mean()),
            "sched_overhead_ms": float(ov.mean()),
        }
