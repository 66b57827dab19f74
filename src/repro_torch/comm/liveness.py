"""Liveness contract + unified straggler diagnostics for every fabric.

Every transport answers the same two questions through the same surface:

* ``ctx.dead_ranks()`` — peers this rank has evidence are gone.  The
  evidence is fabric-native: FileMPI reads heartbeat *files*, ShmComm
  reads the heartbeat *word* each arena owner bumps in its header,
  SocketComm tracks abortive connection death (mid-record EOF /
  ECONNRESET — a clean between-records close is a finalize, not a
  death), and HierComm unions both halves.  Transports without peer
  visibility (thread, local) inherit the empty default.
* ``ctx.pending_snapshot()`` — a bounded snapshot of the matching table:
  (src, tag, seq) keys that have *arrived* but are unclaimed.  A recv
  timeout with a non-empty snapshot is almost always a tag/seq mismatch
  (the data came — the caller asked for the wrong stream), which is a
  very different bug from a dead peer; putting both in the error message
  turns the two failure modes apart at a glance.

``straggler_message`` renders one timeout message format across all
fabrics and publishes the dead-rank count to the obs metrics registry,
so a trace artifact of a degraded run shows liveness alongside restart
counters.

The port's own copy of ``repro.comm.liveness`` (NumPy only), for the checkpoint's
``Dmat`` paths; it differs from the original in its docstrings alone.
"""

from __future__ import annotations

from typing import Any

from ..obs import metrics as _metrics

__all__ = ["dead_ranks", "pending_snapshot", "straggler_message"]

SNAPSHOT_LIMIT = 8


def dead_ranks(ctx: Any) -> list[int]:
    """``ctx``'s dead-peer evidence, sorted; [] when unknowable."""
    fn = getattr(ctx, "dead_ranks", None)
    if fn is None:
        return []
    try:
        return sorted(fn())
    except Exception:  # diagnostics must never mask the real timeout
        return []


def pending_snapshot(ctx: Any, limit: int = SNAPSHOT_LIMIT) -> list:
    """Bounded snapshot of arrived-but-unclaimed matches; [] if none."""
    fn = getattr(ctx, "pending_snapshot", None)
    if fn is None:
        return []
    try:
        return list(fn(limit))[:limit]
    except Exception:
        return []


def straggler_message(ctx: Any, what: str, fabric: str,
                      extra: str = "") -> str:
    """One timeout-message format for every transport.

    ``what`` describes the expected message ("'tag' (seq 3) from rank
    1"); ``fabric`` names the wire.  The dead list and the pending-match
    snapshot ride along so the message distinguishes a dead peer from a
    mismatched tag without a debugger.
    """
    dead = dead_ranks(ctx)
    pending = pending_snapshot(ctx)
    _metrics.gauge("liveness.dead_ranks").set(len(dead))
    msg = (
        f"rank {getattr(ctx, 'pid', '?')} timed out receiving {what} "
        f"over {fabric}; stale-heartbeat ranks: {dead}"
    )
    if pending:
        msg += f"; pending unclaimed (src, tag, seq) matches: {pending}"
    if extra:
        msg += extra
    return msg
