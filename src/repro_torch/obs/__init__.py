"""Observability for the port: the process-wide metrics registry.

``repro_torch.obs.metrics`` is the port's own copy of
``repro.obs.metrics``; the serve engine's ``serve_stats()`` is a view
over it.  Tracing spans come with a later slice.
"""

from . import metrics

__all__ = ["metrics"]
