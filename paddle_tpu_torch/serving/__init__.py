"""Serving of the port: paged KV pool, scheduler and continuous-batching
engine (counterpart: `paddle_tpu/serving`; the router, worker processes,
transport and AOT artifacts are later slices, see ROADMAP.md)."""
from .block_pool import BlockPool, PoolExhausted
from .engine import LLMEngine, ShedRequest
from .scheduler import Request, Scheduler

__all__ = ["BlockPool", "LLMEngine", "PoolExhausted", "Request",
           "Scheduler", "ShedRequest"]
