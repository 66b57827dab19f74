"""Observability for the port: the process-wide metrics registry,
per-process span tracing and the merged-trace report.

``repro_torch.obs.metrics``, ``repro_torch.obs.trace`` and
``repro_torch.obs.report`` are the port's own copies of ``repro.obs``'s
modules (standard library only).  A traced pRUN world
(``pRUN(..., trace=True)``) merges its ranks' buffers into one
Chrome-trace JSON; ``python -m repro_torch.obs.report TRACE.json
[--validate]`` prints its per-op and per-rank tables.  The serve
engine's ``serve_stats()`` is a view over the registry; the engine
records ``serve.prefill``/``serve.decode`` spans and ``serve.ttft``/
``serve.admit_group`` instants, and the training loop a ``train.step``
span per step.  Tracing is off unless ``enable_trace()`` (or
``PPYTHON_TRACE=1``) turns it on.

``repro_torch.obs.device_spans`` (it imports torch, so this package
does not import it) records regions into the same buffer: the MoE
layer's ``moe.dispatch``, ``moe.experts`` and ``moe.combine`` and the
engine's ``engine.sample`` and ``engine.admit``.  Inside an engine step
on the card each region also carries its device time (``device_ms``)
and its device start on the host clock (``device_start``), from CUDA
events the engine resolves once the step's ``serve.*`` span has closed
at its host copy.
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
