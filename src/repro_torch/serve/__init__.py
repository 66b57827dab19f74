"""Serving substrate: continuous batching over batched decode state."""

from .engine import (
    ContinuousBatchingEngine,
    ServeEngine,
    make_prefill_step,
    make_serve_step,
    prefill_pad_for,
)
from .scheduler import QueueFull, Request, Scheduler

__all__ = [
    "ContinuousBatchingEngine",
    "QueueFull",
    "Request",
    "Scheduler",
    "ServeEngine",
    "make_prefill_step",
    "make_serve_step",
    "prefill_pad_for",
]
