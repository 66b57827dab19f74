"""Per-rank ring-buffered span/instant tracing with cross-rank merge.

Design contract (the hot path):

* ``PPYTHON_TRACE=0`` (the default) must cost one module-attribute check
  per call site.  ``span()`` consults the module-level ``enabled`` flag
  and returns a shared no-op context manager when tracing is off; the
  comm instrumentation goes further and installs its wrappers only when
  tracing was enabled at context construction, so an untraced run
  executes the exact original bound methods.
* When enabled, events land in a preallocated ring buffer (capacity
  ``PPYTHON_TRACE_BUF``, default 65536) under a lock — overwrite-oldest,
  never grow, never block the caller on I/O.  Timestamps are
  ``time.perf_counter()`` (monotonic).
* ``merge_traces(ctx)`` runs at the end of a traced pRUN job: rank 0
  estimates each peer's clock offset with a ping handshake (midpoint
  method, best-of-N by RTT), gathers every rank's buffer over the
  existing collectives, and writes one Chrome-trace/Perfetto JSON with
  one track (pid) per rank into ``PPYTHON_TRACE_DIR``.

Stdlib-only on purpose (comm imports this; workers must start fast).

The port's own copy of ``repro.obs.trace`` (standard library only): the
serve engine's spans and the training loop's ``train.step`` record here.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any

__all__ = [
    "enabled",
    "span",
    "instant",
    "enable_trace",
    "disable_trace",
    "reset_trace",
    "events",
    "dropped",
    "instrument_context",
    "merge_traces",
    "write_chrome_trace",
    "DEFAULT_CAPACITY",
]

DEFAULT_CAPACITY = 65536

#: Module-level fast path: every call site checks this one attribute.
enabled: bool = False

_tracer: "_Tracer | None" = None


def _env_flag(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default).lower() not in ("", "0", "false", "no", "off")


def _env_capacity() -> int:
    try:
        cap = int(os.environ.get("PPYTHON_TRACE_BUF", DEFAULT_CAPACITY))
    except ValueError:
        cap = DEFAULT_CAPACITY
    return max(16, cap)


class _Tracer:
    """Preallocated ring buffer of trace events.

    An event is the tuple ``(name, ph, ts, dur, attrs)`` with ``ph`` in
    {"X" (complete span), "i" (instant)}, ``ts``/``dur`` in seconds on
    the local monotonic clock.
    """

    __slots__ = ("capacity", "buf", "n", "lock", "t_start")

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self.buf: list[tuple | None] = [None] * capacity
        self.n = 0
        self.lock = threading.Lock()
        self.t_start = time.perf_counter()

    def record(self, name: str, ph: str, ts: float, dur: float,
               attrs: dict | None) -> None:
        with self.lock:
            i = self.n
            self.n = i + 1
            self.buf[i % self.capacity] = (name, ph, ts, dur, attrs)

    def events(self) -> list[tuple]:
        with self.lock:
            n, cap = self.n, self.capacity
            if n <= cap:
                return [e for e in self.buf[:n]]
            head = n % cap
            return self.buf[head:] + self.buf[:head]

    @property
    def dropped(self) -> int:
        return max(0, self.n - self.capacity)


class _Span:
    """Recording context manager: measures wall time, stores one "X"
    event at exit.  ``set(**attrs)`` adds attributes mid-flight."""

    __slots__ = ("_name", "_attrs", "_t0")

    def __init__(self, name: str, attrs: dict) -> None:
        self._name = name
        self._attrs = attrs

    def set(self, **attrs: Any) -> "_Span":
        self._attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter()
        tr = _tracer
        if tr is not None:
            tr.record(self._name, "X", self._t0, t1 - self._t0, self._attrs)
        return False


class _NoopSpan:
    """Shared do-nothing span: the disabled fast path."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP = _NoopSpan()


def span(name: str, **attrs: Any):
    """``with span("comm.send", peer=1, bytes=n, fabric="shm"): ...``

    Returns the shared no-op singleton when tracing is disabled."""
    if not enabled:
        return _NOOP
    return _Span(name, attrs)


def instant(name: str, **attrs: Any) -> None:
    """Record a zero-duration marker event."""
    if not enabled:
        return
    tr = _tracer
    if tr is not None:
        tr.record(name, "i", time.perf_counter(), 0.0, attrs or None)


def enable_trace(capacity: int | None = None) -> None:
    """Turn tracing on (idempotent); allocates the ring buffer."""
    global enabled, _tracer
    if capacity is None:
        capacity = _env_capacity()
    if _tracer is None or _tracer.capacity != capacity:
        _tracer = _Tracer(capacity)
    enabled = True


def disable_trace() -> None:
    """Turn tracing off; the buffer (and its events) survive."""
    global enabled
    enabled = False


def reset_trace() -> None:
    """Drop all recorded events, keep the enabled state and capacity."""
    global _tracer
    if _tracer is not None:
        _tracer = _Tracer(_tracer.capacity)


def events() -> list[tuple]:
    """Recorded events in order (oldest first)."""
    return _tracer.events() if _tracer is not None else []


def dropped() -> int:
    """Events lost to ring-buffer wraparound."""
    return _tracer.dropped if _tracer is not None else 0


# ---------------------------------------------------------------------------
# Comm-context instrumentation
# ---------------------------------------------------------------------------

_FABRIC_BY_CLASS = {
    "ThreadComm": "thread",
    "FileMPI": "file",
    "SocketComm": "socket",
    "ShmComm": "shm",
    "HierComm": "hier",
    "LocalComm": "local",
}


def _nbytes(obj: Any) -> int:
    nb = getattr(obj, "nbytes", None)
    if nb is not None:
        try:
            return int(nb)
        except (TypeError, ValueError):
            return -1
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    return -1


def _tag_str(tag: Any) -> str:
    s = tag if isinstance(tag, str) else repr(tag)
    return s if len(s) <= 96 else s[:93] + "..."


class _TracedRequest:
    """Wraps a transport Request so ``wait()`` shows up as a span."""

    __slots__ = ("_req", "_attrs")

    def __init__(self, req: Any, attrs: dict) -> None:
        self._req = req
        self._attrs = attrs

    def wait(self, *a: Any, **kw: Any) -> Any:
        if not enabled:
            return self._req.wait(*a, **kw)
        t0 = time.perf_counter()
        try:
            return self._req.wait(*a, **kw)
        finally:
            _tracer.record("comm.wait", "X", t0,
                           time.perf_counter() - t0, self._attrs)

    def test(self) -> bool:
        return self._req.test()

    def __getattr__(self, name: str) -> Any:
        return getattr(self._req, name)


def instrument_context(ctx: Any) -> Any:
    """Wrap ``ctx``'s point-to-point entry points with trace spans.

    Instance-level and idempotent.  When tracing is disabled at call
    time this is a no-op — the context keeps its original bound methods
    and an untraced run pays nothing.  When enabled, each wrapper still
    re-checks ``enabled`` per call so the merge phase (which disables
    tracing around its own handshake traffic) is not self-recorded.

    Fabric attribution: HierComm exposes ``fabric_of(peer)`` ("shm" or
    "tcp"); other transports get a constant label from their class name.
    """
    if not enabled or getattr(ctx, "_obs_instrumented", False):
        return ctx

    fabric_of = getattr(ctx, "fabric_of", None)
    default_fabric = _FABRIC_BY_CLASS.get(
        type(ctx).__name__, type(ctx).__name__.lower()
    )

    def _fab(peer: int) -> str:
        if fabric_of is not None:
            try:
                return fabric_of(peer)
            except Exception:
                return default_fabric
        return default_fabric

    send0 = ctx.send
    recv0 = ctx.recv
    isend0 = ctx.isend
    irecv0 = ctx.irecv
    irecv_into0 = ctx.irecv_into
    wait_all0 = ctx.wait_all

    def send(dest, tag, obj):
        if not enabled:
            return send0(dest, tag, obj)
        t0 = time.perf_counter()
        try:
            return send0(dest, tag, obj)
        finally:
            _tracer.record("comm.send", "X", t0, time.perf_counter() - t0,
                           {"peer": dest, "bytes": _nbytes(obj),
                            "tag": _tag_str(tag), "fabric": _fab(dest)})

    def recv(source, tag, timeout=None):
        if not enabled:
            return recv0(source, tag, timeout)
        t0 = time.perf_counter()
        obj = recv0(source, tag, timeout)
        _tracer.record("comm.recv", "X", t0, time.perf_counter() - t0,
                       {"peer": source, "bytes": _nbytes(obj),
                        "tag": _tag_str(tag), "fabric": _fab(source)})
        return obj

    def isend(dest, tag, obj):
        if not enabled:
            return isend0(dest, tag, obj)
        t0 = time.perf_counter()
        try:
            return isend0(dest, tag, obj)
        finally:
            _tracer.record("comm.isend", "X", t0, time.perf_counter() - t0,
                           {"peer": dest, "bytes": _nbytes(obj),
                            "tag": _tag_str(tag), "fabric": _fab(dest)})

    def irecv(source, tag):
        if not enabled:
            return irecv0(source, tag)
        return _TracedRequest(
            irecv0(source, tag),
            {"peer": source, "tag": _tag_str(tag), "fabric": _fab(source)},
        )

    def irecv_into(source, tag, buffer):
        if not enabled:
            return irecv_into0(source, tag, buffer)
        return _TracedRequest(
            irecv_into0(source, tag, buffer),
            {"peer": source, "bytes": _nbytes(buffer),
             "tag": _tag_str(tag), "fabric": _fab(source), "into": True},
        )

    def wait_all(requests, timeout=None):
        if not enabled:
            return wait_all0(requests, timeout)
        t0 = time.perf_counter()
        try:
            return wait_all0(requests, timeout)
        finally:
            _tracer.record("comm.wait_all", "X", t0,
                           time.perf_counter() - t0, {"n": len(requests)})

    ctx.send = send
    ctx.recv = recv
    ctx.isend = isend
    ctx.irecv = irecv
    ctx.irecv_into = irecv_into
    ctx.wait_all = wait_all
    ctx._obs_instrumented = True
    return ctx


# ---------------------------------------------------------------------------
# Cross-rank merge
# ---------------------------------------------------------------------------


def estimate_clock_offsets(ctx: Any, rounds: int = 8) -> dict[int, float]:
    """Rank 0 pings every peer; returns ``{rank: offset_s}`` on rank 0
    (empty dict elsewhere), where ``peer_clock ~= rank0_clock + offset``.

    Midpoint method: rank 0 sends at t0, the peer replies with its own
    clock reading t_p, rank 0 receives at t1; assuming symmetric delay,
    ``offset = t_p - (t0 + t1) / 2``.  The sample with the smallest RTT
    wins (least queueing noise).  Must be called on all ranks.
    """
    offsets: dict[int, float] = {0: 0.0}
    if ctx.np_ <= 1:
        return offsets if ctx.pid == 0 else {}
    if ctx.pid == 0:
        for peer in range(1, ctx.np_):
            best_rtt = None
            for r in range(rounds):
                tag = ("__obs_clk", peer, r)
                t0 = time.perf_counter()
                ctx.send(peer, tag, None)
                t_p = ctx.recv(peer, tag)
                t1 = time.perf_counter()
                rtt = t1 - t0
                if best_rtt is None or rtt < best_rtt:
                    best_rtt = rtt
                    offsets[peer] = t_p - 0.5 * (t0 + t1)
        return offsets
    for r in range(rounds):
        tag = ("__obs_clk", ctx.pid, r)
        ctx.recv(0, tag)
        ctx.send(0, tag, time.perf_counter())
    return {}


def _json_safe(v: Any) -> Any:
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, (int, float)):
        return v
    try:  # numpy scalars without importing numpy here
        return int(v)
    except (TypeError, ValueError):
        pass
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def trace_path(np_: int, path: str | os.PathLike | None = None) -> Path:
    """Resolve the merged-trace output path (``PPYTHON_TRACE_DIR``)."""
    if path is not None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        return p
    d = Path(os.environ.get("PPYTHON_TRACE_DIR", "."))
    d.mkdir(parents=True, exist_ok=True)
    transport = os.environ.get("PPYTHON_TRANSPORT", "local")
    return d / f"ppython_trace_{transport}_np{np_}.json"


def write_chrome_trace(per_rank: list, offsets: dict[int, float],
                       path: str | os.PathLike | None = None) -> Path:
    """Write gathered per-rank buffers as one Chrome-trace JSON.

    ``per_rank`` holds ``(rank, events, dropped, node_id)`` tuples; each
    rank's timestamps are aligned into rank 0's clock by subtracting its
    offset, then the whole timeline is shifted so the earliest event is
    t=0 and converted to microseconds (the Chrome trace unit).
    """
    aligned: list[tuple[int, list[tuple]]] = []
    t_min = None
    for rank, evs, _drop, _node in per_rank:
        off = offsets.get(rank, 0.0)
        rows = [(name, ph, ts - off, dur, attrs)
                for (name, ph, ts, dur, attrs) in evs]
        for _, _, ts, _, _ in rows:
            if t_min is None or ts < t_min:
                t_min = ts
        aligned.append((rank, rows))
    if t_min is None:
        t_min = 0.0

    trace_events: list[dict] = []
    for rank, evs, drop, node in per_rank:
        pname = f"rank {rank}"
        if node is not None:
            pname += f" (node {node})"
        if drop:
            pname += f" [dropped {drop}]"
        trace_events.append({"name": "process_name", "ph": "M", "pid": rank,
                             "tid": 0, "args": {"name": pname}})
        trace_events.append({"name": "process_sort_index", "ph": "M",
                             "pid": rank, "tid": 0,
                             "args": {"sort_index": rank}})
    for rank, rows in aligned:
        for name, ph, ts, dur, attrs in rows:
            ev: dict[str, Any] = {
                "name": name,
                "cat": name.split(".", 1)[0],
                "ph": ph,
                "ts": (ts - t_min) * 1e6,
                "pid": rank,
                "tid": 0,
            }
            if ph == "X":
                ev["dur"] = dur * 1e6
            else:
                ev["s"] = "t"
            if attrs:
                ev["args"] = {k: _json_safe(v) for k, v in attrs.items()}
            trace_events.append(ev)
    trace_events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))

    doc = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "repro.obs",
            "np": len(per_rank),
            "clock_offsets_s": {str(r): offsets.get(r, 0.0)
                                for r, *_ in per_rank},
            "dropped_events": {str(r): d for r, _e, d, _n in per_rank},
        },
    }
    out = trace_path(len(per_rank), path)
    with open(out, "w") as f:
        json.dump(doc, f)
    return out


def merge_traces(ctx: Any, path: str | os.PathLike | None = None,
                 rounds: int = 8) -> Path | None:
    """Collective: align clocks, gather buffers, write the merged JSON.

    Must be called on every rank of ``ctx``; returns the output path on
    rank 0 and ``None`` elsewhere.  Tracing is suspended for the
    duration so the handshake/gather traffic does not pollute the
    buffers being merged.
    """
    global enabled
    was_enabled = enabled
    enabled = False
    try:
        tr = _tracer
        local = (
            ctx.pid,
            tr.events() if tr is not None else [],
            tr.dropped if tr is not None else 0,
            _node_of(ctx),
        )
        offsets = estimate_clock_offsets(ctx, rounds=rounds)
        gathered = ctx.gather(0, local)
        if ctx.pid != 0 or gathered is None:
            return None
        gathered = sorted(gathered, key=lambda t: t[0])
        return write_chrome_trace(gathered, offsets, path=path)
    finally:
        enabled = was_enabled


def _node_of(ctx: Any) -> int | None:
    node_ids = getattr(ctx, "node_ids", None)
    if node_ids is None:
        return None
    try:
        return int(node_ids[ctx.pid])
    except (TypeError, IndexError, ValueError):
        return None


# Honor the env knob at import: pRUN workers inherit PPYTHON_TRACE from
# the launcher's environment and come up tracing before init() runs.
if _env_flag("PPYTHON_TRACE"):
    enable_trace()
