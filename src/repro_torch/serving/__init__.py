from .engine import RequestResult, ServingEngine
from .worker import Endpoint, ExecutionRecord, Instance, WorkerHost

__all__ = ["Endpoint", "ExecutionRecord", "Instance", "RequestResult", "ServingEngine", "WorkerHost"]
