"""Serving layer: lockstep reference engine, continuous batching and the
paged-KV engine."""

from repro_torch.serve.engine import GenerationResult, ServeEngine
from repro_torch.serve.paged import BlockAllocator, PagedServeEngine
from repro_torch.serve.scheduler import (
    ContinuousServeEngine,
    EngineStats,
    Request,
    RequestOutput,
    ServeStats,
)

__all__ = ["BlockAllocator", "ContinuousServeEngine", "EngineStats",
           "GenerationResult", "PagedServeEngine", "Request",
           "RequestOutput", "ServeEngine", "ServeStats"]
