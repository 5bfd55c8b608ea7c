"""Control plane of the port: the schedulers (copies of the JAX package's
pure-Python ones) and Algorithm 1 on tensors (``sched``)."""

from . import baselines, hiku  # noqa: F401  (register the schedulers)
from .hiku import HikuScheduler
from .sched import (
    ARRIVAL,
    EVICT,
    FINISH,
    BurstDetector,
    JIQState,
    check_invariants,
    init_state,
    sched_many,
    sched_many_adaptive,
    sched_many_fused,
    sched_step,
)
from .scheduler import Scheduler, available_schedulers, make_scheduler

__all__ = [
    "ARRIVAL",
    "EVICT",
    "FINISH",
    "BurstDetector",
    "HikuScheduler",
    "JIQState",
    "Scheduler",
    "available_schedulers",
    "check_invariants",
    "init_state",
    "make_scheduler",
    "sched_many",
    "sched_many_adaptive",
    "sched_many_fused",
    "sched_step",
]
