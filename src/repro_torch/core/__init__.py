"""Control plane of the port: the schedulers (copies of the JAX package's
pure-Python ones), Algorithm 1 on tensors (``sched``), and the discrete-event
cluster simulator with its workload, record and metric modules (copies of the
JAX package's pure-numpy ones)."""

from . import baselines, hiku  # noqa: F401  (register the schedulers)
from .hiku import HikuScheduler
from .metrics import (
    RunMetrics,
    latency_cdf,
    load_cv_per_second,
    summarize,
    summarize_window,
    summarize_windows,
)
from .records import RecordAccumulator, RecordColumns, RequestRecord
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
from .simulator import SalvagedVU, SimConfig, Simulator, StolenTask
from .trace import FunctionSpec, default_n_events, make_functions, make_vu_programs
from .workloads import Scenario, available_scenarios, make_scenario

__all__ = [
    "ARRIVAL",
    "EVICT",
    "FINISH",
    "BurstDetector",
    "FunctionSpec",
    "HikuScheduler",
    "JIQState",
    "RecordAccumulator",
    "RecordColumns",
    "RequestRecord",
    "RunMetrics",
    "SalvagedVU",
    "Scenario",
    "Scheduler",
    "SimConfig",
    "Simulator",
    "StolenTask",
    "available_scenarios",
    "available_schedulers",
    "check_invariants",
    "default_n_events",
    "init_state",
    "latency_cdf",
    "load_cv_per_second",
    "make_functions",
    "make_scenario",
    "make_scheduler",
    "make_vu_programs",
    "sched_many",
    "sched_many_adaptive",
    "sched_many_fused",
    "sched_step",
    "summarize",
    "summarize_window",
    "summarize_windows",
]
