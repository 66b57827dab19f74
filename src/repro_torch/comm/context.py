"""Communication context: the MPI subset pPython needs (paper §III.D).

======================  ====================================================
MPI                     pPython
======================  ====================================================
MPI_Init                ``init()`` — transport picked by
                        ``PPYTHON_TRANSPORT=file|socket|shm|hier|thread``:
                        ``file`` = the paper's shared-directory PythonMPI,
                        ``socket`` = TCP peer mesh bootstrapped through a
                        rendezvous (no shared filesystem), ``shm`` =
                        single-node mmap'd ring arenas (``PPYTHON_SHM_DIR``,
                        memory-speed multi-process), ``hier`` = composite
                        shm-within-a-node / TCP-across-nodes with
                        topology-aware collectives, ``thread`` =
                        in-process ranks (``run_spmd``/pRUN only)
MPI_Comm_size / _rank   ``.np_`` / ``.pid``
MPI_Send / MPI_Recv     ``.send`` / ``.recv`` (plus ``isend``/``irecv``/
                        ``wait_all`` non-blocking requests)
MPI_Irecv(buf)          ``.irecv_into`` — receive *into* caller memory;
                        serializing transports decode payload bytes
                        directly into the buffer (redistribution lands
                        coalesced blocks straight in ``dst.local``)
MPI_Bcast               ``.bcast``      — binomial tree / chunked ring /
                                          one-file on FileMPI, frozen-
                                          buffer tree on ThreadComm;
                                          ShmComm raises the eager
                                          switch point to 256 KiB
                                          (``collectives.py``)
MPI_Barrier             ``.barrier``    — dissemination
MPI_Gather              ``.gather``     — arrival-order flat / binomial
MPI_Allgather           ``.allgather``  — recursive doubling / ring
MPI_Allreduce           ``Group.allreduce`` — recursive doubling / ring
MPI_Reduce              ``Group.reduce``    — binomial tree
MPI_Reduce_scatter      ``Group.reduce_scatter`` — ring
MPI_Alltoallv           ``Group.alltoallv``      — pairwise exchange
MPI_Comm_create_group   ``collectives.group_of(ctx, ranks)``
MPI_Finalize            ``.finalize()``
======================  ====================================================

The derived collectives on ``CommContext`` are thin delegations to the
algorithm layer in ``collectives.py``, which picks tree/ring/recursive-
doubling variants by message size (``PPYTHON_COLL_EAGER_BYTES``) and
scopes any rank subset through ``Group``.  SocketComm runs the same
algorithm layer unmodified — it is a serializing transport without the
one-file broadcast hook, so auto ``bcast`` resolves to the eager tree or
the chunked ring by payload size.  A module-level active context gives
pPython programs the paper's ``pPython.Np`` / ``pPython.Pid`` view of
the world.

The port's own copy of ``repro.comm.context`` (NumPy only), for the checkpoint's
``Dmat`` paths; it differs from the original in its docstrings alone.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

import numpy as np

__all__ = [
    "CommContext",
    "LocalComm",
    "Request",
    "SendRequest",
    "RecvRequest",
    "RecvIntoRequest",
    "StragglerTimeout",
    "ctx_counter",
    "get_context",
    "land_into",
    "set_context",
    "init",
    "recv_timeout",
    "run_epoch",
    "Np",
    "Pid",
]


def recv_timeout() -> float:
    """Receive deadline in seconds (``PPYTHON_RECV_TIMEOUT``, default
    300).  Read at *call* time — not frozen at import — so launchers and
    tests can tune it per run (pRUN exports it to workers, a test can
    monkeypatch it) without re-importing the comm stack."""
    return float(os.environ.get("PPYTHON_RECV_TIMEOUT", "300"))


def run_epoch() -> int:
    """This process's world generation (``PPYTHON_EPOCH``, default 0).

    pRUN bumps it on every gang restart; transports stamp it into their
    bootstrap artifacts (rendezvous registrations, socket HELLOs, shm
    arena headers, file-message names) so a survivor or ghost of an
    earlier generation can never be mistaken for a member of the current
    one."""
    return int(os.environ.get("PPYTHON_EPOCH", "0") or 0)


CTX_COUNTER_WINDOW = 1024


def ctx_counter(ctx: "CommContext", name) -> int:
    """SPMD-aligned per-context counter: all ranks run the same program,
    so the Nth call under one ``name`` returns N everywhere — the basis
    for collision-free collective/synch/agg message tags.

    Wraps at ``CTX_COUNTER_WINDOW`` so long-running iterative programs
    mint a bounded tag set (transports keep one FIFO seq slot per
    (peer, tag) stream forever; unbounded tags would leak that table).
    Reuse is safe: per-stream FIFO sequencing matches repeats in program
    order, so the window only has to exceed the number of *concurrently
    in-flight* operations per name — and every collective completes
    before its caller returns."""
    counters = getattr(ctx, "_pp_counters", None)
    if counters is None:
        counters = {}
        ctx._pp_counters = counters
    val = counters.get(name, 0)
    counters[name] = (val + 1) % CTX_COUNTER_WINDOW
    return val


class StragglerTimeout(RuntimeError):
    """A receive exceeded its deadline — the peer is straggling or dead."""


class Request:
    """Handle for a non-blocking point-to-point operation.

    ``test()`` polls for completion without blocking; ``wait()`` blocks
    until completion and returns the payload (``None`` for sends).  A
    timed-out ``wait`` raises ``StragglerTimeout`` but leaves the request
    valid — it can be waited on again.
    """

    def test(self) -> bool:
        raise NotImplementedError

    def wait(self, timeout: float | None = None) -> Any:
        raise NotImplementedError


class SendRequest(Request):
    """Already-complete send: every transport here is one-sided, so posting
    a message *is* its completion event."""

    def test(self) -> bool:
        return True

    def wait(self, timeout: float | None = None) -> None:
        return None


class RecvRequest(Request):
    """Generic polling receive built on ``probe``/``recv``.

    Transports with per-(source, tag) sequence streams override ``irecv``
    with a seq-reserving request so multiple receives can be outstanding
    on one stream; this fallback supports one outstanding request per
    stream, which is all the derived collectives need.
    """

    def __init__(self, ctx: "CommContext", source: int, tag: Any):
        self._ctx = ctx
        self._source = source
        self._tag = tag
        self._done = False
        self._value: Any = None

    def test(self) -> bool:
        if self._done:
            return True
        if self._ctx.probe(self._source, self._tag):
            self._value = self._ctx.recv(self._source, self._tag)
            self._done = True
        return self._done

    def wait(self, timeout: float | None = None) -> Any:
        if not self._done:
            self._value = self._ctx.recv(self._source, self._tag, timeout=timeout)
            self._done = True
        return self._value


def land_into(buffer: np.ndarray, payload: Any) -> np.ndarray:
    """Materialize a received ndarray ``payload`` into the caller-owned
    ``buffer`` (the completion step of ``irecv_into``).

    Element counts must match; the payload is reshaped to the buffer's
    shape and copied with assignment-casting semantics, so a sender using
    a different-but-castable dtype still lands.  Two fast paths: a
    payload a transport already reconstructed *over* the buffer's memory
    (same data pointer, dtype, contiguity) returns immediately, and a
    payload that merely overlaps the buffer (e.g. raw bytes landed under
    a mismatched dtype) is defensively copied before the casting
    assignment so the overlap can't corrupt it mid-copy.
    """
    if not isinstance(payload, np.ndarray):
        raise TypeError(
            f"irecv_into expects ndarray traffic, got {type(payload)}"
        )
    if payload.size != buffer.size:
        raise ValueError(
            f"irecv_into buffer holds {buffer.size} elements but the "
            f"payload carries {payload.size}"
        )
    if (payload.dtype == buffer.dtype
            and payload.__array_interface__["data"][0]
            == buffer.__array_interface__["data"][0]
            and payload.flags["C_CONTIGUOUS"]
            and buffer.flags["C_CONTIGUOUS"]):
        return buffer  # transport decoded the payload in place
    if np.may_share_memory(payload, buffer):
        payload = payload.copy()
    buffer[...] = payload.reshape(buffer.shape)
    return buffer


class RecvIntoRequest(Request):
    """Generic ``irecv_into`` handle: completes an inner receive request,
    then lands the payload into the caller's buffer exactly once.

    Transports with a cheaper route to caller memory (FileMPI decoding a
    frame straight into the buffer, SocketComm pre-registering it with
    the wire reader) override ``irecv_into`` with their own requests;
    this wrapper is the contract's universal fallback and the whole
    implementation for the by-reference transports, where the copy out
    of the sender's posted array is required anyway.
    """

    def __init__(self, inner: Request, buffer: np.ndarray):
        self._inner = inner
        self._buffer = buffer
        self._done = False

    def test(self) -> bool:
        if not self._done and self._inner.test():
            land_into(self._buffer, self._inner.wait(timeout=0.0))
            self._done = True
        return self._done

    def wait(self, timeout: float | None = None) -> np.ndarray:
        if not self._done:
            land_into(self._buffer, self._inner.wait(timeout=timeout))
            self._done = True
        return self._buffer


class CommContext:
    """Abstract SPMD communication context."""

    np_: int
    pid: int
    # world generation this context was built in (pRUN bumps it per gang
    # restart); process transports override with the live env value
    epoch: int = 0

    # -- liveness contract (see comm/liveness.py) -----------------------------

    def dead_ranks(self) -> list[int]:
        """Peers this rank has evidence are gone.  The base contract is
        honest ignorance: transports without peer visibility return []."""
        return []

    def pending_snapshot(self, limit: int = 8) -> list:
        """Arrived-but-unclaimed (src, tag, seq) matches, bounded."""
        return []

    def epoch_reset(self, peer: int, epoch: int | None = None) -> None:
        """Drop all per-``peer`` stream state at a generation boundary
        (seq counters, cached connections/arenas, unclaimed matches).
        No-op for transports without cross-process stream state."""
        if epoch is not None:
            self.epoch = int(epoch)

    # -- required primitives -------------------------------------------------

    def send(self, dest: int, tag: Any, obj: Any) -> None:
        raise NotImplementedError

    def recv(self, source: int, tag: Any, timeout: float | None = None) -> Any:
        raise NotImplementedError

    def probe(self, source: int, tag: Any) -> bool:
        raise NotImplementedError

    def finalize(self) -> None:  # MPI_Finalize
        pass

    # -- non-blocking primitives ----------------------------------------------

    def isend(self, dest: int, tag: Any, obj: Any) -> Request:
        """Post a send and return its (already-complete) request handle.

        All transports here are one-sided — a send never waits for its
        matching receive — so the default posts eagerly.
        """
        self.send(dest, tag, obj)
        return SendRequest()

    def irecv(self, source: int, tag: Any) -> Request:
        """Post a receive; complete it later with ``wait()``/``test()``."""
        return RecvRequest(self, source, tag)

    def irecv_into(self, source: int, tag: Any,
                   buffer: np.ndarray) -> Request:
        """Post a receive that completes *into* a caller-owned buffer.

        ``buffer`` is a writable ndarray (any shape) whose element count
        matches the incoming array payload; ``wait()`` returns the
        buffer.  The default lands via :func:`land_into` after a plain
        ``irecv``; serializing transports override this to decode the
        payload bytes directly into ``buffer`` with no intermediate
        allocation, which is what lets redistribution receive coalesced
        blocks straight into plan staging — or into ``dst.local``
        itself.
        """
        return RecvIntoRequest(self.irecv(source, tag), buffer)

    @staticmethod
    def wait_all(requests, timeout: float | None = None) -> list:
        """Complete a batch of requests in *arrival* order.

        Returns payloads positionally (matching ``requests``).  Arrival-order
        completion lets a receiver drain whichever peer finished first rather
        than serializing on the slowest one.
        """
        deadline = time.monotonic() + (
            recv_timeout() if timeout is None else timeout
        )
        out: list[Any] = [None] * len(requests)
        pending = {i: r for i, r in enumerate(requests)}
        pause = 0.0
        while pending:
            progressed = False
            for i in list(pending):
                if pending[i].test():
                    out[i] = pending.pop(i).wait(timeout=0.0)
                    progressed = True
            if not pending:
                break
            if progressed:
                pause = 0.0
                continue
            if time.monotonic() > deadline:
                raise StragglerTimeout(
                    f"wait_all timed out with {len(pending)} of "
                    f"{len(requests)} requests incomplete"
                )
            time.sleep(pause)
            pause = min(pause + 0.0005, 0.02)
        return out

    # -- derived collectives --------------------------------------------------
    #
    # Thin delegations to the algorithm layer (collectives.py), which
    # picks tree/ring/recursive-doubling variants by message size.  The
    # import is deferred: collectives imports this module.

    def _world(self):
        from .collectives import world_group

        return world_group(self)

    def bcast(self, root: int, obj: Any = None, tag: Any = None) -> Any:
        if self.np_ == 1:
            return obj
        return self._world().bcast(obj, root=root, tag=tag)

    def barrier(self, tag: Any = None) -> None:
        if self.np_ == 1:
            return
        self._world().barrier(tag=tag)

    def gather(self, root: int, obj: Any, tag: Any = None) -> list | None:
        if self.np_ == 1:
            return [obj]
        return self._world().gather(obj, root=root, tag=tag)

    def allgather(self, obj: Any, tag: Any = None) -> list:
        if self.np_ == 1:
            return [obj]
        return self._world().allgather(obj, tag=tag)

    # -- identity ---------------------------------------------------------------

    def __repr__(self) -> str:
        return f"{type(self).__name__}(np={self.np_}, pid={self.pid})"


class LocalComm(CommContext):
    """Np=1 context: message ops are in-memory self-sends."""

    def __init__(self) -> None:
        self.np_ = 1
        self.pid = 0
        self._box: dict[tuple, Any] = {}

    def send(self, dest: int, tag: Any, obj: Any) -> None:
        if dest != 0:
            raise ValueError(f"LocalComm has a single rank; dest={dest}")
        self._box[(0, _freeze(tag))] = obj

    def recv(self, source: int, tag: Any, timeout: float | None = None) -> Any:
        key = (source, _freeze(tag))
        if key not in self._box:
            raise StragglerTimeout(f"no local message with tag {tag!r}")
        return self._box.pop(key)

    def probe(self, source: int, tag: Any) -> bool:
        return (source, _freeze(tag)) in self._box


def _freeze(tag: Any):
    if isinstance(tag, (list, tuple)):
        return tuple(_freeze(t) for t in tag)
    return tag


# ---------------------------------------------------------------------------
# Active-context management (pPython_init, paper §III.A)
# ---------------------------------------------------------------------------

_active = threading.local()
_global_ctx: CommContext | None = None


def init(ctx: CommContext | None = None) -> CommContext:
    """pPython_init: install the active context.

    With no argument, builds one from the environment the launcher sets
    (``PPYTHON_NP``/``PPYTHON_PID`` plus per-transport wiring) or falls
    back to a single-rank LocalComm — which is what makes unmodified
    pPython programs run serially on a laptop.

    ``PPYTHON_TRANSPORT`` selects the fabric:

    * ``file`` (default) — the paper's shared-directory PythonMPI
      (needs ``PPYTHON_COMM_DIR`` on a shared filesystem).
    * ``socket`` — TCP peer mesh; endpoints are exchanged through a
      rendezvous (``PPYTHON_RDZV_ADDR`` TCP bootstrap, or
      ``PPYTHON_RDZV_DIR``/``PPYTHON_COMM_DIR`` one-time file exchange).
      No shared filesystem on any message path.
    * ``shm`` — single-node multi-process over mmap'd ring arenas in
      ``PPYTHON_SHM_DIR`` (pRUN places it under ``/dev/shm``); falls
      back to ``<PPYTHON_COMM_DIR>/shm`` when only a comm dir is set.
    * ``hier`` — topology-aware composite: the socket rendezvous also
      exchanges a node fingerprint (``PPYTHON_NODE_ID`` override →
      virtual nodes), then same-node peers talk through shm arenas and
      cross-node peers over TCP; needs the socket rendezvous wiring
      plus ``PPYTHON_SHM_DIR`` (or ``PPYTHON_COMM_DIR``).
    * ``thread`` — in-process ranks; only meaningful inside a process
      that hosts the whole world (``run_spmd`` / ``pRUN(...,
      transport="thread")`` install contexts directly), so ``init()``
      rejects it with a pointer rather than silently mis-wiring.
    """
    global _global_ctx
    if ctx is None:
        np_ = int(os.environ.get("PPYTHON_NP", "1"))
        transport = os.environ.get("PPYTHON_TRANSPORT", "file").lower() or "file"
        if np_ > 1:
            if transport == "socket":
                from .socketcomm import SocketComm

                ctx = SocketComm.bootstrap(
                    np_=np_, pid=int(os.environ["PPYTHON_PID"])
                )
            elif transport == "file":
                from .filempi import FileMPI

                ctx = FileMPI(
                    np_=np_,
                    pid=int(os.environ["PPYTHON_PID"]),
                    comm_dir=os.environ["PPYTHON_COMM_DIR"],
                )
            elif transport == "shm":
                from .shmcomm import ShmComm

                shm_dir = os.environ.get("PPYTHON_SHM_DIR")
                if not shm_dir:
                    comm_dir = os.environ.get("PPYTHON_COMM_DIR")
                    if not comm_dir:
                        raise ValueError(
                            "PPYTHON_TRANSPORT=shm needs PPYTHON_SHM_DIR "
                            "(or PPYTHON_COMM_DIR to derive it from)"
                        )
                    shm_dir = os.path.join(comm_dir, "shm")
                ctx = ShmComm(
                    np_=np_,
                    pid=int(os.environ["PPYTHON_PID"]),
                    shm_dir=shm_dir,
                )
            elif transport == "hier":
                from .hiercomm import HierComm

                ctx = HierComm.bootstrap(
                    np_=np_, pid=int(os.environ["PPYTHON_PID"])
                )
            elif transport == "thread":
                raise ValueError(
                    "PPYTHON_TRANSPORT=thread hosts all ranks inside one "
                    "process: launch through repro.comm.run_spmd or "
                    "pRUN(..., transport='thread') instead of init()"
                )
            else:
                raise ValueError(
                    f"unknown PPYTHON_TRANSPORT {transport!r} "
                    "(expected file|socket|shm|hier|thread)"
                )
        else:
            ctx = LocalComm()
    # no-op unless PPYTHON_TRACE=1: wraps p2p entry points with spans
    from ..obs.trace import instrument_context

    ctx = instrument_context(ctx)
    # no-op unless PPYTHON_FAULT arms a fault for this (rank, epoch);
    # outermost so an armed kill fires before the transport is entered
    from .faultinject import instrument_faults

    _global_ctx = instrument_faults(ctx)
    return _global_ctx


def set_context(ctx: CommContext | None) -> None:
    """Install a thread-local context (used by ThreadComm SPMD harnesses)."""
    _active.ctx = ctx


def get_context() -> CommContext:
    ctx = getattr(_active, "ctx", None)
    if ctx is not None:
        return ctx
    global _global_ctx
    if _global_ctx is None:
        init()
    return _global_ctx


def Np() -> int:
    return get_context().np_


def Pid() -> int:
    return get_context().pid
