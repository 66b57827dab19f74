"""Device-timed regions inside the port, placed on the host clock.

``region(name, **attrs)`` is ``trace.span`` for code that queues work
on the card.  With tracing off it returns ``trace``'s shared no-op (one
attribute check: no object, no CUDA event).  With tracing on it records
one ``"X"`` event into ``trace``'s ring buffer: the name, the host start
and duration (``time.perf_counter``) and the attributes.

Inside an engine step the region is also timed on the device.  The
engine calls ``anchor(device)`` at the top of each admission and decode
step, where the stream is idle (the previous step's one copy to the
host waited for it): on a CUDA device that records a timing event
together with the host time.  Until ``resolve()``, each region records
a start and an end ``torch.cuda.Event(enable_timing=True)`` on the
step's stream (the current one at the anchor; events from a reused
pool) and is held back.  A region opened with ``after=`` the region
just before it, with no device work queued between the two, takes that
region's end event as its start: the two events would mark the same
point of the stream.  ``resolve()`` runs once the step's copy to the
host has returned, when every event of the step has completed, so it
waits for nothing; the engine calls it once the step's ``serve.*`` span
has closed, so the span still ends at the copy.  It reads each event's
time from the anchor once and adds to each held region

* ``device_ms``: the stream time between its two events, and
* ``device_start``: its device start on the host clock, the anchor's
  host time plus the anchor's elapsed time to the region's start event,

then writes the regions to the buffer in program order.  Outside an
engine step (training, fake tensors, the CPU) a region is a host span
only and nothing is held back.  The events are pooled by device: a CUDA
event records only on a stream of the device it was first recorded on.

This module imports torch; ``obs/__init__.py`` does not import it, so
pPython's layer stays free of torch.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import torch

from . import trace as _trace

__all__ = ["region", "anchor", "resolve"]


class _Step:
    """An engine step's stream, anchor and held-back regions."""

    __slots__ = ("stream", "pool", "event", "host", "pending")

    def __init__(self, stream) -> None:
        self.stream = stream  # passed to each record: no current_stream() a record
        self.pool = _pools.setdefault(stream.device_index, [])
        self.event = _event(self.pool)
        self.event.record(stream)
        self.host = time.perf_counter()
        self.pending: list[tuple] = []  # (name, t0, dur, attrs, start, end)


_local = threading.local()  # .step: the open _Step of this thread, or None
# free events by device index; dict.setdefault, list.pop and list.extend
# are atomic, so threads share the pools
_pools: dict[int, list[torch.cuda.Event]] = {}


def _event(pool: list) -> torch.cuda.Event:
    try:
        return pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Region:
    """Recording context manager: one "X" event, device-timed while an
    engine step is anchored.  ``set(**attrs)`` adds attributes."""

    __slots__ = ("_name", "_attrs", "_after", "_t0", "_step", "_start", "_end")

    def __init__(self, name: str, after, attrs: dict) -> None:
        self._name = name
        self._after = after
        self._attrs = attrs

    def set(self, **attrs: Any) -> "_Region":
        self._attrs.update(attrs)
        return self

    def __enter__(self) -> "_Region":
        self._step = step = getattr(_local, "step", None)
        if step is not None:
            prev = self._after
            shared = getattr(prev, "_end", None) if getattr(prev, "_step", None) is step else None
            if shared is not None and step.pending[-1][5] is shared:
                self._start = shared
            else:
                self._start = _event(step.pool)
                self._start.record(step.stream)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter()
        step = self._step
        if step is not None:
            if getattr(_local, "step", None) is step:
                self._end = end = _event(step.pool)
                end.record(step.stream)
                step.pending.append((self._name, self._t0, t1 - self._t0, self._attrs,
                                     self._start, end))
                return False
            # the step was resolved or dropped while this region was open
            if not any(p[5] is self._start for p in step.pending):
                step.pool.append(self._start)
        tr = _trace._tracer
        if tr is not None:
            tr.record(self._name, "X", self._t0, t1 - self._t0, self._attrs)
        return False


def region(name: str, after=None, **attrs: Any):
    """``with region("moe.experts", after=dispatch, rows=n): ...``

    ``after``: the region that closed just before this one opens, with no
    device work queued in between (its end event is this one's start).
    Returns ``trace``'s shared no-op when tracing is off."""
    if not _trace.enabled:
        return _trace._NOOP
    return _Region(name, after, attrs)


def anchor(device: torch.device) -> None:
    """Open an engine step on ``device``: on a CUDA device with tracing
    on, record the anchor event and the host time; the regions until
    ``resolve()`` are device-timed.  A step left unresolved (it raised,
    or tracing went off before ``resolve()``) is dropped."""
    _drop()
    if not _trace.enabled or device.type != "cuda":
        return
    _local.step = _Step(torch.cuda.current_stream(device))


def resolve() -> None:
    """Close the open engine step, once its copy to the host has
    returned: give each held region ``device_ms`` and ``device_start``
    and write it to the trace buffer.  Adds no host sync."""
    step = getattr(_local, "step", None)
    if step is None:
        return
    _local.step = None
    tr = _trace._tracer
    anchor_ev = step.event
    ms: dict[int, float] = {}  # ms from the anchor, by event
    for name, t0, dur, attrs, start, end in step.pending:
        a = ms.get(id(start))
        if a is None:
            a = ms[id(start)] = anchor_ev.elapsed_time(start)
        b = ms[id(end)] = anchor_ev.elapsed_time(end)
        attrs["device_ms"] = b - a
        attrs["device_start"] = step.host + 1e-3 * a
        if tr is not None:
            tr.record(name, "X", t0, dur, attrs)
    _release(step)


def _release(step: _Step) -> None:
    used = {id(step.event): step.event}
    for p in step.pending:
        used[id(p[4])] = p[4]
        used[id(p[5])] = p[5]
    step.pool.extend(used.values())


def _drop() -> None:
    step = getattr(_local, "step", None)
    if step is not None:
        _local.step = None
        _release(step)
