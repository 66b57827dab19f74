"""Observability for the port: the process-wide metrics registry and
per-process span tracing.

``repro_torch.obs.metrics`` and ``repro_torch.obs.trace`` are the port's
own copies of ``repro.obs.metrics`` and ``repro.obs.trace``.  The serve
engine's ``serve_stats()`` is a view over the registry; the engine
records ``serve.prefill``/``serve.decode`` spans and ``serve.ttft``/
``serve.admit_group`` instants, and the training loop a ``train.step``
span per step.  Tracing is off unless ``enable_trace()`` (or
``PPYTHON_TRACE=1``) turns it on.
"""

from . import metrics, trace
from .trace import (
    disable_trace,
    enable_trace,
    instant,
    instrument_context,
    merge_traces,
    reset_trace,
    span,
)

__all__ = [
    "metrics",
    "trace",
    "span",
    "instant",
    "enable_trace",
    "disable_trace",
    "reset_trace",
    "instrument_context",
    "merge_traces",
]
