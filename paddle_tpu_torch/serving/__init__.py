"""Serving of the port (counterpart: `paddle_tpu/serving`): the paged KV
pool, scheduler and continuous-batching engine; the router over N
replicas (`router`), the framed transport (`transport`) and the
process-per-replica worker (`worker`); the per-bucket AOT serving
artifacts (`aot`: export and load of the engine's programs as
AOTInductor packages)."""
from .block_pool import BlockPool, PoolExhausted
from .engine import LLMEngine, ShedRequest
from .router import (EngineReplica, ReplicaGone, ReplicaHandle,
                     RoutedRequest, Router)
from .scheduler import Request, Scheduler
from .transport import (ChannelClosed, FrameError, TransportError,
                        TransportPolicy, TransportTimeout)
from .worker import ProcReplica, RemoteRequest, WorkerDied
from .aot import export_serving_artifacts, load_serving_artifacts

__all__ = ["BlockPool", "PoolExhausted", "Request", "Scheduler",
           "LLMEngine", "ShedRequest", "Router", "RoutedRequest",
           "ReplicaHandle", "ReplicaGone", "EngineReplica",
           "ProcReplica", "RemoteRequest", "WorkerDied",
           "TransportError", "TransportPolicy", "TransportTimeout",
           "FrameError", "ChannelClosed",
           "export_serving_artifacts", "load_serving_artifacts"]
