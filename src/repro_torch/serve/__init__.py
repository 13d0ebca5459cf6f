"""Serving layer: lockstep reference engine and continuous batching."""

from repro_torch.serve.engine import GenerationResult, ServeEngine
from repro_torch.serve.scheduler import (
    ContinuousServeEngine,
    Request,
    RequestOutput,
    ServeStats,
)

__all__ = ["ContinuousServeEngine", "GenerationResult", "Request",
           "RequestOutput", "ServeEngine", "ServeStats"]
