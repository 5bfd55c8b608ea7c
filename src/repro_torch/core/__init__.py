"""Control plane of the port: the schedulers (copies of the JAX package's
pure-Python ones), Algorithm 1 on tensors (``sched``), the discrete-event
cluster simulator with its workload, record and metric modules, and the
multi-cluster tier over it — the sharded driver, the global admission tier
with its policies, estimators, event plane, autoscaler, work stealing, chaos
plans and scripted replay (copies of the JAX package's pure-numpy ones)."""

from . import baselines, hiku  # noqa: F401  (register the schedulers)
from .admission import (
    AdmissionConfig,
    AdmissionRun,
    AdmissionShard,
    AdmissionSimulator,
)
from .autoscale import AutoscaleActuator, AutoscaleConfig, Autoscaler
from .chaos import (
    FaultEvent,
    FaultPlan,
    flappy_workers,
    rolling_restart,
    shard_kill_wave,
    spot_preemption,
)
from .estimators import BanditTuner, DurationEstimator
from .eventplane import EventPlane, MetricEvent
from .hiku import HikuScheduler
from .metrics import (
    RunMetrics,
    latency_cdf,
    load_cv_per_second,
    summarize,
    summarize_window,
    summarize_windows,
)
from .policies import (
    AdmissionPolicy,
    ShardState,
    available_policies,
    make_policy,
    register_policy,
    unregister_policy,
)
from .records import RecordAccumulator, RecordColumns, RequestRecord
from .replay import ShardScript, replay_shards, scripts_from_run
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
from .shard import (
    MergedRun,
    ShardedSimulator,
    ShardResult,
    ShardSpec,
    StreamChunk,
    shard_seed,
)
from .simulator import SalvagedVU, SimConfig, Simulator, StolenTask
from .stealing import Migration, Salvage, drain_tick, steal_tick
from .trace import FunctionSpec, default_n_events, make_functions, make_vu_programs
from .workloads import Scenario, available_scenarios, make_scenario

__all__ = [
    "ARRIVAL",
    "AdmissionConfig",
    "AdmissionPolicy",
    "AdmissionRun",
    "AdmissionShard",
    "AdmissionSimulator",
    "AutoscaleActuator",
    "AutoscaleConfig",
    "Autoscaler",
    "BanditTuner",
    "BurstDetector",
    "DurationEstimator",
    "EVICT",
    "EventPlane",
    "FINISH",
    "FaultEvent",
    "FaultPlan",
    "FunctionSpec",
    "HikuScheduler",
    "JIQState",
    "MergedRun",
    "MetricEvent",
    "Migration",
    "RecordAccumulator",
    "RecordColumns",
    "RequestRecord",
    "RunMetrics",
    "Salvage",
    "SalvagedVU",
    "Scenario",
    "Scheduler",
    "ShardResult",
    "ShardScript",
    "ShardSpec",
    "ShardState",
    "ShardedSimulator",
    "SimConfig",
    "Simulator",
    "StolenTask",
    "StreamChunk",
    "available_policies",
    "available_scenarios",
    "available_schedulers",
    "check_invariants",
    "default_n_events",
    "drain_tick",
    "flappy_workers",
    "init_state",
    "latency_cdf",
    "load_cv_per_second",
    "make_functions",
    "make_policy",
    "make_scenario",
    "make_scheduler",
    "make_vu_programs",
    "register_policy",
    "replay_shards",
    "rolling_restart",
    "sched_many",
    "sched_many_adaptive",
    "sched_many_fused",
    "sched_step",
    "scripts_from_run",
    "shard_kill_wave",
    "shard_seed",
    "spot_preemption",
    "steal_tick",
    "summarize",
    "summarize_window",
    "summarize_windows",
    "unregister_policy",
]
