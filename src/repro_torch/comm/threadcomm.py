"""ThreadComm: in-process SPMD transport for tests and benchmarks.

Semantically identical to FileMPI (one-sided sends, FIFO per (src,tag))
but messages travel through in-memory queues, so a multi-rank pPython
program can run inside one Python process.  ``run_spmd(fn, np_)`` launches
``np_`` threads, installs each rank's context thread-locally, runs ``fn``
as the SPMD body, and returns the per-rank results.

The port's own copy of ``repro.comm.threadcomm`` (NumPy only), for the checkpoint's
``Dmat`` paths; it differs from the original in its docstrings alone.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Callable

from .context import (
    CommContext,
    Request,
    StragglerTimeout,
    _freeze,
    recv_timeout,
    set_context,
)

__all__ = ["ThreadComm", "ThreadWorld", "run_spmd"]

_MISSING = object()


class ThreadWorld:
    """Shared mailbox fabric for one SPMD execution.

    Wakeups are *targeted*: each (src, dst, tag, seq) key has at most one
    receiver (seq slots are reserved per receive), so a blocked ``take``
    parks on a per-key ``Event`` and ``post`` wakes exactly that thread.
    The broadcast ``notify_all`` this replaces woke every rank on every
    message — an O(P) thundering herd per post that dominated collective
    latency once np outgrew the core count."""

    def __init__(self, np_: int):
        self.np_ = np_
        self._lock = threading.Lock()
        # (src, dst, tag_token, seq) -> payload
        self._box: dict[tuple, Any] = {}
        # key -> Event of the (single) receiver parked on that key
        self._waiters: dict[tuple, threading.Event] = {}

    def post(self, key: tuple, obj: Any) -> None:
        with self._lock:
            self._box[key] = obj
            ev = self._waiters.pop(key, None)
        if ev is not None:
            ev.set()

    def take(self, key: tuple, timeout: float) -> Any:
        deadline = time.monotonic() + timeout
        with self._lock:
            if key in self._box:
                return self._box.pop(key)
            ev = self._waiters.setdefault(key, threading.Event())
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not ev.wait(min(remaining, 0.2)):
                with self._lock:
                    if key in self._box:  # raced with a late post
                        self._waiters.pop(key, None)
                        return self._box.pop(key)
                    if time.monotonic() >= deadline:
                        self._waiters.pop(key, None)
                        raise StragglerTimeout(
                            f"thread recv timed out on {key}"
                        )
                continue
            with self._lock:
                return self._box.pop(key)

    def take_nowait(self, key: tuple) -> Any:
        """Claim ``key`` if posted, else return the ``_MISSING`` sentinel."""
        with self._lock:
            return self._box.pop(key, _MISSING)

    def peek(self, key: tuple) -> bool:
        with self._lock:
            return key in self._box

    def keys(self) -> list[tuple]:
        """Snapshot of arrived-but-unclaimed match keys (diagnostics)."""
        with self._lock:
            return list(self._box.keys())

    def purge(self, pred) -> int:
        """Drop every posted entry whose key satisfies ``pred`` — the
        epoch-boundary reset for fabrics that use the mailbox as their
        matching table (a dead generation's in-flight messages must not
        satisfy the restarted generation's receives)."""
        with self._lock:
            doomed = [k for k in self._box if pred(k)]
            for k in doomed:
                del self._box[k]
            return len(doomed)


class _ThreadRecvRequest(Request):
    """Receive handle bound to a reserved (source, tag, seq) slot."""

    def __init__(self, world: ThreadWorld, key: tuple):
        self._world = world
        self._box_key = key
        self._done = False
        self._value: Any = None

    def test(self) -> bool:
        if not self._done:
            got = self._world.take_nowait(self._box_key)
            if got is not _MISSING:
                self._value = got
                self._done = True
        return self._done

    def wait(self, timeout: float | None = None) -> Any:
        if not self._done:
            self._value = self._world.take(
                self._box_key,
                recv_timeout() if timeout is None else timeout,
            )
            self._done = True
        return self._value


class ThreadComm(CommContext):
    """In-process rank endpoint.

    Payloads travel **by reference**: ``send`` posts the object itself into
    the shared mailbox (no pickling, no copy), so an ndarray arrives as the
    identical buffer the sender handed over.  Senders of mutable payloads
    must therefore either stop mutating after posting or send an explicit
    copy — exactly MPI's "don't touch the buffer until the send completes"
    contract, except completion here is the matching receive.

    ``irecv_into`` (inherited from :class:`CommContext`) completes by
    copying the posted array into the caller's buffer — on a by-reference
    transport that copy *is* the pin that detaches the receiver from the
    sender's memory, so the generic implementation is already optimal
    here.
    """

    # tells the collectives layer that posted objects alias the sender's
    # buffers, so every collective hop must pin (copy) array payloads
    payload_by_reference = True

    def __init__(self, world: ThreadWorld, pid: int):
        self.world = world
        self.np_ = world.np_
        self.pid = pid
        self._send_seq: dict[tuple, int] = defaultdict(int)
        # next *unreserved* receive seq per (source, tag): blocking recv
        # commits it only after the message is claimed (a timed-out recv
        # leaves the stream position unchanged); irecv reserves it eagerly
        # so several receives can be outstanding on one stream.
        self._recv_seq: dict[tuple, int] = defaultdict(int)

    def _key(self, src: int, dst: int, tag: Any, seq: int) -> tuple:
        return (src, dst, _freeze(tag), seq)

    def send(self, dest: int, tag: Any, obj: Any) -> None:
        if not (0 <= dest < self.np_):
            raise ValueError(f"dest {dest} out of range for np={self.np_}")
        k = (dest, _freeze(tag))
        seq = self._send_seq[k]
        self._send_seq[k] = seq + 1
        self.world.post(self._key(self.pid, dest, tag, seq), obj)

    def recv(self, source: int, tag: Any, timeout: float | None = None) -> Any:
        k = (source, _freeze(tag))
        seq = self._recv_seq[k]
        obj = self.world.take(
            self._key(source, self.pid, tag, seq),
            recv_timeout() if timeout is None else timeout,
        )
        self._recv_seq[k] = seq + 1  # commit only after a successful claim
        return obj

    def irecv(self, source: int, tag: Any) -> Request:
        k = (source, _freeze(tag))
        seq = self._recv_seq[k]
        self._recv_seq[k] = seq + 1  # reserve the stream slot now
        return _ThreadRecvRequest(
            self.world, self._key(source, self.pid, tag, seq)
        )

    def probe(self, source: int, tag: Any) -> bool:
        k = (source, _freeze(tag))
        seq = self._recv_seq[k]
        return self.world.peek(self._key(source, self.pid, tag, seq))


def run_spmd(
    fn: Callable[..., Any],
    np_: int,
    args: tuple = (),
    timeout: float = 120.0,
) -> list[Any]:
    """Run ``fn(*args)`` as an SPMD body on ``np_`` thread-ranks.

    Each thread sees its own rank via the active comm context
    (``repro_torch.comm.Np()/Pid()``); results are returned rank-ordered.
    Exceptions in any rank are re-raised in the caller.
    """
    world = ThreadWorld(np_)
    results: list[Any] = [None] * np_
    errors: list[BaseException | None] = [None] * np_

    from ..obs.trace import instrument_context

    def body(pid: int) -> None:
        # no-op unless PPYTHON_TRACE=1
        set_context(instrument_context(ThreadComm(world, pid)))
        try:
            results[pid] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - surfaced to caller
            errors[pid] = e
        finally:
            set_context(None)

    threads = [threading.Thread(target=body, args=(pid,)) for pid in range(np_)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    for t in threads:
        if t.is_alive():
            raise StragglerTimeout("SPMD thread body did not finish in time")
    for e in errors:
        if e is not None:
            raise e
    return results
