from .batching import ContinuousBatcher, GenRequest
from .engine import RequestResult, ServingEngine
from .kv_cache import CacheManager, Slot
from .worker import Endpoint, ExecutionRecord, Instance, WorkerHost

__all__ = ["CacheManager", "ContinuousBatcher", "Endpoint", "ExecutionRecord", "GenRequest",
           "Instance", "RequestResult", "ServingEngine", "Slot", "WorkerHost"]
