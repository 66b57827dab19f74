"""ShmComm: mmap'd shared-memory arena transport — single-node
multi-process pPython at memory speed.

The paper's claim is that pPython runs "transparently on a laptop" —
but with pRUN's processes on one node, every message still pays either
the filesystem (FileMPI: pickle + fsync + rename + poll) or the kernel
socket stack (SocketComm loopback).  ShmComm keeps the exact transport
contract the algorithm layer was written against (one-sided ``send``,
per-(src, tag) FIFO sequence streams, ``probe``/``irecv`` request
semantics, ``irecv_into``, ``PPYTHON_MAX_MSG_BYTES`` chunking) and moves
the bytes through shared memory instead — the ARMCI/UPC++ lineage's
answer to intra-node PGAS traffic:

* **One mmap'd ring-buffer arena per directed peer pair.**  Rank ``d``
  creates (at init, via tmp-file + atomic rename) a file-backed arena
  ``arena_s<s>_d<d>.ring`` for every sender ``s``; the sender attaches
  on first send.  Single producer, single consumer, no locks: the
  producer owns the head cursor, the consumer owns the tail, and each
  cursor is published twice (a seqlock pair) so a torn 8-byte read is
  detected and retried instead of mis-framing the ring.  pRUN places
  the arena directory under ``/dev/shm`` when the node has it, so the
  pages never touch a disk writeback path.
* **Exactly one copy each way.**  A send writes the pickle-5 head plus
  each out-of-band buffer straight from the exporter's memory into the
  ring (producer copy); the receiver reconstructs arrays over fresh
  buffers filled from the ring (consumer copy).  When the caller posted
  ``irecv_into``, the frame header resolves the payload *straight into
  the caller's buffer* — the consumer copy lands in its final
  destination, nothing intermediate is allocated.
* **Futex-free polling with targeted wakeup.**  There is no background
  reader thread and no cross-process futex: a receive drains the rank's
  inbound arenas inline into a (src, tag, seq)-keyed mailbox and claims
  its own slot, spinning through ``sleep(0)`` yields first — the hot
  path from producer memcpy to consumer claim crosses no scheduler
  wakeup.  A receive that outlives the spin window *parks*: it raises a
  parked flag in each inbound arena header and selects on the rank's
  **doorbell** (a Unix datagram socket); a producer that publishes into
  an arena whose flag is up pokes that doorbell with one byte, so a
  parked consumer wakes with kernel precision instead of a poll
  quantum, and an idle rank consumes no CPU.  The spin window is
  adaptive: with more local ranks than cores (``np_`` over
  ``os.cpu_count()``), waiters park immediately — yield-spinning there
  hands the core to other waiters instead of the producer and convoys
  the whole world (``PPYTHON_SHM_SPIN_SECONDS`` overrides).
  Out-of-order tags,
  outstanding irecvs, and probe all resolve against the mailbox exactly
  as on the other fabrics.
* **Oversize payloads chunk**, at ``PPYTHON_MAX_MSG_BYTES`` exactly like
  FileMPI/SocketComm, and additionally at a quarter of the arena
  capacity so any payload streams through a bounded ring: the sender
  waits for ring space (draining its *own* inbound arenas meanwhile, so
  two ranks flooding each other can never deadlock) and the receiver
  reassembles into one preallocated buffer.

Arena lifecycle: the receiver-creator unlinks its inbound arenas at
``finalize()``; launchers (``pRUN(transport="shm")``) remove the whole
arena directory even when workers crash — shared-memory files are RAM,
a leak survives the process.  Every arena header carries the launcher's
run nonce (``PPYTHON_SHM_NONCE``), so a sender can never attach to a
stale arena left by a dead run in a reused directory: it waits for the
current run's receiver to publish a fresh one.

Memory-ordering assumption: the cursor seqlock detects *torn* 8-byte
reads, but cross-process visibility ordering (record bytes before the
head publish) relies on the host's store order — guaranteed on x86's
TSO, and backstopped everywhere by the record magic check, which turns
a mis-ordered read into a loud ``RuntimeError`` rather than silent
mis-framing.  Pure Python has no portable store fence; if an exotic
weakly-ordered target ever matters, the publish path is the one place a
barrier belongs.
"""

from __future__ import annotations

import hashlib
import mmap
import os
import pickle
import select
import socket
import struct
import sys
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np

from ..obs import metrics as _metrics
from .context import (
    CommContext,
    Request,
    StragglerTimeout,
    land_into as _land_into,
    recv_timeout,
    run_epoch,
)
from .frame import (
    chunk_windows,
    decode_frame,
    encode_frame,
    max_msg_bytes,
    tag_token,
)
from .liveness import SNAPSHOT_LIMIT, straggler_message

__all__ = ["ShmComm", "arena_paths", "default_arena_bytes"]

# Arena header v2: magic, capacity, run-nonce, epoch — then (at fixed
# offsets) the two seqlock cursor pairs, the consumer's parked flag, and
# the owner's heartbeat word.  Cursors are monotonically increasing byte
# counts (they never wrap; only offsets into the data region do),
# published value-then-check so a reader retries a torn 8-byte load
# instead of acting on it.  The epoch field fences elastic restarts: a
# restarted owner recreates its arenas under a bumped epoch, and a
# survivor confirms a replacement by seeing same-nonce + higher on-disk
# epoch (structurally no false positives — a paused-but-alive owner's
# file keeps its old epoch).  The heartbeat word is a little-endian f64
# wall-clock stamp the owner's beat thread bumps; its staleness is the
# cheap first-stage liveness probe that gates the disk header read.
_ARENA_HDR = struct.Struct("<8sQQQ")  # magic, cap, nonce, epoch
_ARENA_MAGIC = b"PPSHMA2\0"
_DATA_OFF = 128
_OFF_HEAD = 32   # byte offsets of the cursor fields within the header
_OFF_HEAD2 = 40
_OFF_TAIL = 48
_OFF_TAIL2 = 56
_OFF_PARKED = 64  # 1 byte: consumer is parked on its doorbell
_OFF_HBEAT = 72   # f64 wall-clock heartbeat stamp, owner-written
_U64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")

# Record header (mirrors SocketComm's wire record): magic, kind, tag
# token length, seq, head length, nbuf — followed by nbuf u64 buffer
# lengths, the tag token, the head bytes, and the raw buffers.
_REC = struct.Struct("<4sBIQQI")
_REC_MAGIC = b"PPSM"
_K_MSG = 1
_K_CHUNK = 2
_CHUNK_META = struct.Struct("<QQ")

DEFAULT_ARENA_BYTES = 4 << 20
_ATTACH_RETRY = 0.005
_STALE_CHECK_PERIOD = 0.05   # how often a blocked sender re-probes liveness
DEFAULT_HEARTBEAT_PERIOD = 1.0
_SPIN_SECONDS = 0.002    # yield-spin window before a poll starts parking
_PARK_MIN = 0.0005       # first parked wait (cross-process poll floor)
_PARK_MAX = 0.05         # idle ceiling (same as FileMPI's poll cap)

_MISSING = object()


class _PeerRestarted(Exception):
    """A blocked send's target arena was replaced under a bumped epoch:
    the owner died and its restarted incarnation recreated the ring.
    ``send`` catches this, re-attaches, resets the stream, and retries."""

    def __init__(self, dest: int):
        super().__init__(f"peer {dest} restarted (arena epoch bumped)")
        self.dest = dest


def _spin_window(np_: int) -> float:
    """Seconds of ``sleep(0)`` yield-spinning before a waiter parks.

    Spinning is only profitable when the waiter is not stealing the
    producer's core.  With more local ranks than cores every yield-spin
    timeslice goes to another waiter instead of the rank that could be
    publishing — the convoy makes latency *worse* than a kernel wakeup —
    so oversubscribed worlds park immediately on the doorbell (the poke
    path is kernel-precise either way).  ``PPYTHON_SHM_SPIN_SECONDS``
    overrides the heuristic in either direction."""
    env = os.environ.get("PPYTHON_SHM_SPIN_SECONDS")
    if env is not None and env != "":
        return max(0.0, float(env))
    return _SPIN_SECONDS if np_ <= (os.cpu_count() or 1) else 0.0


def _doorbell_address(shm_dir: Path, pid: int):
    """The rank's doorbell datagram address, derivable by any producer.

    Linux gets an abstract-namespace name (no filesystem entry, vanishes
    with the process — nothing to clean up after a crash); elsewhere a
    socket file inside the arena directory."""
    if sys.platform.startswith("linux"):
        tok = hashlib.sha1(str(Path(shm_dir).resolve()).encode())
        return f"\0ppshm-{tok.hexdigest()[:20]}-{pid}"
    return str(Path(shm_dir) / f"wake_{pid}.sock")


def default_arena_bytes() -> int:
    """Per-direction ring capacity (``PPYTHON_SHM_ARENA_BYTES``)."""
    raw = os.environ.get("PPYTHON_SHM_ARENA_BYTES", "")
    return int(raw) if raw else DEFAULT_ARENA_BYTES


def _nonce_u64(nonce: str) -> int:
    return int.from_bytes(
        hashlib.sha1(nonce.encode()).digest()[:8], "little"
    )


def arena_paths(shm_dir: str | os.PathLike, np_: int,
                pid: int) -> list[Path]:
    """The inbound arena files rank ``pid`` owns (creates and unlinks)."""
    d = Path(shm_dir)
    return [d / f"arena_s{s}_d{pid}.ring" for s in range(np_) if s != pid]


class _Arena:
    """One directed ring: a fixed header plus a byte ring, mmap'd shared.

    The creator (the consumer) publishes the file via tmp + atomic
    rename, so an attacher can never observe a half-initialized header;
    the producer attaches read-write and verifies magic + run nonce.
    Head and tail are monotonic u64 byte counts mirrored locally by
    their owning side, so only the *foreign* cursor is ever seqlock-read.
    """

    def __init__(self, path: Path, mm: mmap.mmap, cap: int, epoch: int = 0):
        self.path = path
        self._mm = mm
        self._mv = memoryview(mm)
        self._data = self._mv[_DATA_OFF : _DATA_OFF + cap]
        self.cap = cap
        self.epoch = epoch
        self.head = self._read_cursor(_OFF_HEAD, _OFF_HEAD2)
        self.tail = self._read_cursor(_OFF_TAIL, _OFF_TAIL2)

    # -- construction --------------------------------------------------------

    @classmethod
    def create(cls, path: Path, cap: int, nonce: int,
               epoch: int = 0) -> "_Arena":
        tmp = path.with_suffix(f".tmp{os.getpid()}_{threading.get_ident()}")
        with open(tmp, "wb") as f:
            f.write(_ARENA_HDR.pack(_ARENA_MAGIC, cap, nonce, epoch))
            f.write(b"\0" * (_DATA_OFF - _ARENA_HDR.size))
            f.truncate(_DATA_OFF + cap)
        os.rename(tmp, path)  # atomic publish: attachers see a whole header
        arena = cls._map(path, cap, epoch)
        arena.beat()  # the heartbeat is live from birth, never zero
        return arena

    @classmethod
    def attach(cls, path: Path, nonce: int,
               min_epoch: int = 0) -> "_Arena | None":
        """Producer-side attach; None if the file is missing, not an
        arena, belongs to a different run (stale directory reuse), or
        predates ``min_epoch`` (a dead generation's leftover)."""
        try:
            with open(path, "rb") as f:
                hdr = f.read(_ARENA_HDR.size)
        except OSError:
            return None
        if len(hdr) != _ARENA_HDR.size:
            return None
        magic, cap, file_nonce, epoch = _ARENA_HDR.unpack(hdr)
        if magic != _ARENA_MAGIC or file_nonce != nonce:
            return None
        if epoch < min_epoch:
            return None
        try:
            return cls._map(path, cap, epoch)
        except (OSError, ValueError):
            return None

    @classmethod
    def _map(cls, path: Path, cap: int, epoch: int = 0) -> "_Arena":
        with open(path, "r+b") as f:
            mm = mmap.mmap(f.fileno(), _DATA_OFF + cap)
        return cls(path, mm, cap, epoch)

    def close(self) -> None:
        try:
            self._data.release()
            self._mv.release()
            self._mm.close()
        except (BufferError, ValueError):
            pass  # a transient exported view outlives us; the GC reclaims

    # -- seqlock cursors -----------------------------------------------------

    def _read_cursor(self, off: int, off2: int) -> int:
        while True:
            v1 = _U64.unpack_from(self._mv, off)[0]
            v2 = _U64.unpack_from(self._mv, off2)[0]
            if v1 == v2:
                return v1
            # torn read: the owner is mid-publish, retry

    def _write_cursor(self, off: int, off2: int, value: int) -> None:
        # check-field first, value-field second: a reader that sees them
        # equal is guaranteed the data written before this publish is in
        # place (single host, cache-coherent mmap)
        _U64.pack_into(self._mv, off2, value)
        _U64.pack_into(self._mv, off, value)

    def foreign_tail(self) -> int:
        return self._read_cursor(_OFF_TAIL, _OFF_TAIL2)

    def foreign_head(self) -> int:
        return self._read_cursor(_OFF_HEAD, _OFF_HEAD2)

    def publish_head(self) -> None:
        self._write_cursor(_OFF_HEAD, _OFF_HEAD2, self.head)

    def publish_tail(self) -> None:
        self._write_cursor(_OFF_TAIL, _OFF_TAIL2, self.tail)

    # the parked flag is a single byte: consumer-written, producer-read

    def set_parked(self, parked: bool) -> None:
        self._mv[_OFF_PARKED] = 1 if parked else 0

    def consumer_parked(self) -> bool:
        return self._mv[_OFF_PARKED] != 0

    # the heartbeat word is owner-written, peer-read; a torn f64 read is
    # harmless (it feeds an age threshold, and the next read self-heals)

    def beat(self, now: float | None = None) -> None:
        _F64.pack_into(self._mv, _OFF_HBEAT, time.time() if now is None
                       else now)

    def heartbeat(self) -> float:
        return _F64.unpack_from(self._mv, _OFF_HBEAT)[0]

    # -- byte ring I/O (positions are monotonic counts; offsets wrap) --------

    def free(self) -> int:
        return self.cap - (self.head - self.foreign_tail())

    def copy_in(self, data) -> None:
        """Append ``data`` at the head cursor (caller checked free space;
        the head is published separately, once per whole record)."""
        mv = memoryview(data).cast("B") if not isinstance(data, memoryview) \
            else data.cast("B")
        n = len(mv)
        off = self.head % self.cap
        first = min(n, self.cap - off)
        self._data[off : off + first] = mv[:first]
        if first < n:
            self._data[: n - first] = mv[first:]
        self.head += n

    def read_into(self, pos: int, out: memoryview) -> None:
        """Fill ``out`` from ring position ``pos`` (no cursor movement)."""
        n = len(out)
        off = pos % self.cap
        first = min(n, self.cap - off)
        out[:first] = self._data[off : off + first]
        if first < n:
            out[first:] = self._data[: n - first]

    def read_bytes(self, pos: int, n: int) -> bytes:
        out = memoryview(bytearray(n))
        self.read_into(pos, out)
        return bytes(out)


class _ShmRecvRequest(Request):
    """Receive handle bound to a reserved (source, tag, seq) slot."""

    def __init__(self, ctx: "ShmComm", source: int, tag: Any, seq: int):
        self._ctx = ctx
        self._key = (source, tag_token(tag), seq)
        self._tag = tag
        self._done = False
        self._value: Any = None

    def test(self) -> bool:
        if not self._done:
            got, _ = self._ctx._poll(self._key)
            if got is not _MISSING:
                self._value = got
                self._done = True
        return self._done

    def wait(self, timeout: float | None = None) -> Any:
        if not self._done:
            self._value = self._ctx._take(
                self._key, self._tag,
                recv_timeout() if timeout is None else timeout,
            )
            self._done = True
        return self._value


class _ShmRecvIntoRequest(_ShmRecvRequest):
    """Reserved-slot receive completing into a caller buffer.

    The buffer was registered with the drain loop at post time; when the
    drain matched it, the ring bytes were copied straight into caller
    memory and ``land_into`` recognizes the payload as already landed.
    A message that raced ahead of the post (or mismatched) lands with
    the generic casting copy; either way the registration is dropped.
    """

    def __init__(self, ctx: "ShmComm", source: int, tag: Any, seq: int,
                 buffer: np.ndarray):
        super().__init__(ctx, source, tag, seq)
        self._buffer = buffer

    def test(self) -> bool:
        if not self._done:
            got, _ = self._ctx._poll(self._key)
            if got is not _MISSING:
                self._ctx._drop_registration(self._key)
                _land_into(self._buffer, got)
                self._done = True
        return self._done

    def wait(self, timeout: float | None = None) -> np.ndarray:
        if not self._done:
            try:
                got = self._ctx._take(
                    self._key, self._tag,
                    recv_timeout() if timeout is None else timeout,
                )
            except StragglerTimeout:
                # caller is giving up: a late message must decode into
                # its own buffer, not caller memory the program moved on
                # from
                self._ctx._drop_registration(self._key)
                raise
            self._ctx._drop_registration(self._key)
            _land_into(self._buffer, got)
            self._done = True
        return self._buffer


class ShmComm(CommContext):
    """Shared-memory rank endpoint over per-peer ring arenas.

    ``shm_dir`` holds the arena files; every rank of one run must agree
    on it (and on ``nonce``, normally via ``PPYTHON_SHM_NONCE`` set by
    the launcher).  This rank creates its ``np_ - 1`` inbound arenas at
    construction — replacing any stale files a dead run left — and
    attaches outbound arenas lazily on first send.

    ``senders`` restricts which peers get inbound arenas: a composite
    transport (HierComm) that routes only same-node traffic through
    shared memory passes the same-node peer list so no ring is ever
    allocated for a pair that will talk over another fabric.  Sends to
    peers outside the restriction fail at attach time (no arena exists),
    which is the desired loud failure for a routing bug.
    """

    # intra-node memory bandwidth keeps the eager tree competitive far
    # past the wire-transport default: collectives switch to chunked
    # ring/rendezvous algorithms at 256 KiB instead of 64 KiB
    coll_eager_default = 256 * 1024

    def __init__(self, np_: int, pid: int, shm_dir: str | os.PathLike,
                 arena_bytes: int | None = None, nonce: str | None = None,
                 senders=None, epoch: int | None = None,
                 heartbeat: bool = True,
                 heartbeat_period: float | None = None):
        if not (0 <= pid < np_):
            raise ValueError(f"pid {pid} out of range for np={np_}")
        self.np_ = np_
        self.pid = pid
        self.epoch = run_epoch() if epoch is None else int(epoch)
        self.dir = Path(shm_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        if nonce is None:
            nonce = os.environ.get("PPYTHON_SHM_NONCE", "")
        self._nonce = _nonce_u64(nonce)
        cap = arena_bytes if arena_bytes else default_arena_bytes()
        if cap < 4096:
            raise ValueError(f"arena capacity {cap} is below the 4096-byte "
                             "minimum (records must fit)")
        # a single record (chunk payload + framing) must fit the ring
        # with room to pipeline: cap payloads at a quarter of capacity
        self._chunk_cap = max(2048, cap // 4)
        self._spin = _spin_window(np_)
        # doorbell: bound BEFORE the arenas are published, so a producer
        # that attaches can always reach it
        self._door = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        addr = _doorbell_address(self.dir, pid)
        if not addr.startswith("\0"):
            try:
                os.unlink(addr)  # stale socket file from a dead run
            except FileNotFoundError:
                pass
        self._door.bind(addr)
        self._door.setblocking(False)
        allowed = None if senders is None else {int(s) for s in senders}
        self._in: dict[int, _Arena] = {}
        for path in arena_paths(self.dir, np_, pid):
            src = int(path.name.split("_")[1][1:])
            if allowed is not None and src not in allowed:
                continue
            try:
                os.unlink(path)  # stale arena from a dead run: replace
            except FileNotFoundError:
                pass
            self._in[src] = _Arena.create(path, cap, self._nonce, self.epoch)
        self._out: dict[int, _Arena] = {}
        self._door_addrs: dict[int, str] = {}
        self._send_seq: dict[tuple[int, str], int] = {}
        # next unreserved receive seq per (source, tag): blocking ``recv``
        # commits it only after the message is claimed; ``irecv`` reserves
        # eagerly so several receives can be outstanding on one stream.
        self._recv_seq: dict[tuple[int, str], int] = {}
        # (src, tag_token, seq) -> decoded payload; drained inline by the
        # receiving rank (no background thread), guarded for safety when
        # a harness touches one context from several threads
        self._mail: dict[tuple, Any] = {}
        self._lock = threading.Lock()
        self._partial: dict[tuple, tuple[bytearray, list]] = {}
        self._recv_into_bufs: dict[tuple, np.ndarray] = {}
        self._closed = False
        # liveness: this rank beats the heartbeat word in every inbound
        # arena it owns; peers read it (mapped on their outbound side) as
        # the cheap first-stage staleness probe.  ``PPYTHON_SHM_HEARTBEAT``
        # tunes the period; 0 disables (tests do this to simulate death).
        if heartbeat_period is None:
            raw = os.environ.get("PPYTHON_SHM_HEARTBEAT", "")
            heartbeat_period = float(raw) if raw else DEFAULT_HEARTBEAT_PERIOD
        self._hb_period = heartbeat_period
        self._hb_max_age = 4.0 * heartbeat_period if heartbeat_period else 4.0
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        if heartbeat and heartbeat_period > 0 and self._in:
            self._hb_thread = threading.Thread(
                target=self._beat_loop, name=f"ppshm-beat-{pid}", daemon=True
            )
            self._hb_thread.start()

    def _beat_loop(self) -> None:
        while not self._hb_stop.wait(self._hb_period):
            now = time.time()
            for arena in self._in.values():
                try:
                    arena.beat(now)
                except ValueError:
                    return  # views released: finalize() ran

    # -- send path ------------------------------------------------------------

    def _arena_to(self, dest: int, min_epoch: int = 0) -> _Arena:
        arena = self._out.get(dest)
        if arena is not None:
            if not self._arena_stale(arena):
                return arena
            arena = self._reattach(dest, arena)
            if arena is not None:
                return arena
        path = self.dir / f"arena_s{self.pid}_d{dest}.ring"
        deadline = time.monotonic() + recv_timeout()
        while True:
            arena = _Arena.attach(path, self._nonce, min_epoch)
            if arena is not None:
                self._out[dest] = arena
                return arena
            if self._closed or time.monotonic() > deadline:
                raise StragglerTimeout(
                    f"rank {self.pid} found no live arena to rank {dest} "
                    f"at {path} (peer not initialized, or stale run dir)"
                )
            time.sleep(_ATTACH_RETRY)

    def _arena_stale(self, arena: _Arena) -> bool:
        """True when ``arena``'s owner died *and was replaced*.

        Two stages: the mapped heartbeat's age is the cheap gate (a live
        owner beats every ``_hb_period``); only a stale heartbeat pays
        the on-disk header read, and replacement is confirmed solely by
        same-nonce + **higher epoch** on disk — a paused-but-alive
        owner's file still carries the old epoch, so there are
        structurally no false positives."""
        try:
            age = time.time() - arena.heartbeat()
        except ValueError:
            return True  # our mapping was closed under us
        if age < self._hb_max_age:
            return False
        try:
            with open(arena.path, "rb") as f:
                hdr = f.read(_ARENA_HDR.size)
        except OSError:
            return False  # gone entirely: let the attach loop handle it
        if len(hdr) != _ARENA_HDR.size:
            return False
        magic, _, file_nonce, file_epoch = _ARENA_HDR.unpack(hdr)
        return (magic == _ARENA_MAGIC and file_nonce == self._nonce
                and file_epoch > arena.epoch)

    def _reattach(self, dest: int, old: _Arena) -> "_Arena | None":
        """Swap to ``dest``'s recreated arena after its restart: unmap
        the ghost, reset every per-peer stream (the restarted incarnation
        sends and expects seq 0), and attach the bumped-epoch ring."""
        min_epoch = old.epoch + 1
        self._out.pop(dest, None)
        old.close()
        self.epoch_reset(dest)
        arena = _Arena.attach(old.path, self._nonce, min_epoch)
        if arena is not None:
            self._out[dest] = arena
            _metrics.counter("elastic.arena_reattach").inc()
        return arena

    def _poke(self, dest: int) -> None:
        """Ring ``dest``'s doorbell (best-effort: a full or vanished
        doorbell just means the consumer is already awake or gone)."""
        addr = self._door_addrs.get(dest)
        if addr is None:
            # resolve() walks the filesystem — cache per peer, not per poke
            addr = self._door_addrs[dest] = _doorbell_address(self.dir, dest)
        try:
            self._door.sendto(b"!", addr)
        except OSError:
            pass

    def _write_record(self, dest: int, arena: _Arena, kind: int, tok: bytes,
                      seq: int, head, raws: list) -> None:
        lens = struct.pack(f"<{len(raws)}Q", *[len(r) for r in raws])
        prefix = (
            _REC.pack(_REC_MAGIC, kind, len(tok), seq, len(head), len(raws))
            + lens + tok
        )
        total = len(prefix) + len(head) + sum(len(r) for r in raws)
        if total > arena.cap:
            raise ValueError(
                f"record of {total} bytes exceeds the {arena.cap}-byte "
                "arena (chunking should have split it)"
            )
        now = time.monotonic()
        deadline = now + recv_timeout()
        spin_until = now + self._spin
        stale_check = now + _STALE_CHECK_PERIOD
        while arena.free() < total:
            # keep our own inbound rings draining while we wait for the
            # consumer to make room — two ranks flooding each other can
            # then never deadlock on mutually full rings
            self._drain()
            if arena.free() >= total:
                break
            now = time.monotonic()
            if now >= stale_check:
                # a consumer that died mid-stream never frees ring space:
                # probe for its restarted incarnation so the send can
                # move to the fresh ring instead of timing out
                stale_check = now + _STALE_CHECK_PERIOD
                if self._arena_stale(arena):
                    raise _PeerRestarted(dest)
            if now > deadline:
                raise StragglerTimeout(
                    f"rank {self.pid} timed out waiting for {total} bytes "
                    f"of ring space toward the owner of {arena.path.name} "
                    "(receiver not draining?)"
                )
            time.sleep(0 if now < spin_until else _PARK_MIN)
        arena.copy_in(prefix)
        arena.copy_in(head)
        for r in raws:
            arena.copy_in(r)
        arena.publish_head()  # the record becomes visible atomically
        if arena.consumer_parked():
            self._poke(dest)

    def send(self, dest: int, tag: Any, obj: Any) -> None:
        if not (0 <= dest < self.np_):
            raise ValueError(f"dest {dest} out of range for np={self.np_}")
        tok_str = tag_token(tag)
        tok = tok_str.encode()
        key = (dest, tok_str)
        if dest == self.pid:
            # self-send: no ring exists for (p, p) — round-trip the frame
            # through a writable buffer so the receiver gets the same
            # private, mutable payload a ring delivery would produce
            seq = self._send_seq.get(key, 0)
            self._send_seq[key] = seq + 1
            blob = bytearray()
            for p in encode_frame(obj):
                blob += p
            with self._lock:
                self._mail[(dest, tok_str, seq)] = decode_frame(blob)
            return
        # one serialization either way: the flat frame is both the size
        # probe and (when oversize) the chunked payload
        parts = encode_frame(obj)
        total = sum(len(p) for p in parts)
        env_limit = max_msg_bytes()
        limit = min(env_limit, self._chunk_cap) if env_limit \
            else self._chunk_cap
        # resolve the arena BEFORE minting the seq: when the peer
        # restarted, ``_arena_to`` re-attaches and ``epoch_reset`` zeroes
        # the stream, and the seq minted below is already the one the
        # fresh incarnation expects.  A restart caught mid-wait inside
        # ``_write_record`` surfaces as ``_PeerRestarted``; one retry
        # re-resolves and re-sends the whole payload on the new ring
        # (the dead ring's partial chunks died with their consumer).
        for attempt in (0, 1):
            arena = self._arena_to(dest)
            seq = self._send_seq.get(key, 0)
            try:
                if total > limit:
                    # oversize: stream the flat frame as <= limit CHUNK
                    # records on the same (tag, seq), reassembled into
                    # one buffer on the receive side
                    for off, slices in chunk_windows(parts, limit):
                        self._write_record(
                            dest, arena, _K_CHUNK, tok, seq,
                            _CHUNK_META.pack(off, total), slices,
                        )
                else:
                    self._write_record(dest, arena, _K_MSG, tok, seq,
                                       parts[0], parts[1:-2])
            except _PeerRestarted:
                if attempt:
                    raise StragglerTimeout(
                        f"rank {self.pid} saw rank {dest} restart twice "
                        "within one send"
                    ) from None
                continue
            self._send_seq[key] = seq + 1
            return

    # -- receive path ----------------------------------------------------------

    def _drain(self) -> bool:
        """Pull every complete record out of the inbound arenas into the
        mailbox.  Returns True when anything landed."""
        with self._lock:
            progressed = False
            for src, arena in self._in.items():
                head = arena.foreign_head()
                if arena.tail >= head:
                    continue
                while arena.tail < head:
                    self._consume_record(src, arena)
                # publish only where something was consumed: a spurious
                # tail publish dirties a cache line the producer polls
                arena.publish_tail()
                progressed = True
            return progressed

    def _consume_record(self, src: int, arena: _Arena) -> None:
        pos = arena.tail
        hdr = arena.read_bytes(pos, _REC.size)
        magic, kind, tag_len, seq, head_len, nbuf = _REC.unpack(hdr)
        if magic != _REC_MAGIC:
            raise RuntimeError(
                f"rank {self.pid} found a corrupt record from rank {src} "
                f"at ring offset {pos % arena.cap} (bad magic {magic!r})"
            )
        pos += _REC.size
        lens = struct.unpack(f"<{nbuf}Q", arena.read_bytes(pos, 8 * nbuf))
        pos += 8 * nbuf
        tok = arena.read_bytes(pos, tag_len).decode()
        pos += tag_len
        key = (src, tok, seq)
        if kind == _K_MSG:
            head = arena.read_bytes(pos, head_len)
            pos += head_len
            target = None
            if nbuf == 1:
                reg = self._recv_into_bufs.get(key)
                if reg is not None and reg.nbytes == lens[0]:
                    target = self._recv_into_bufs.pop(key)
            if target is not None:
                # zero receive-side copy beyond the ring read: the frame
                # header resolves the payload straight into the caller's
                # buffer
                mv = memoryview(target).cast("B")
                arena.read_into(pos, mv)
                pos += lens[0]
                obj = pickle.loads(head, buffers=[mv])
            else:
                bufs = []
                for n in lens:
                    b = memoryview(bytearray(n))
                    arena.read_into(pos, b)
                    pos += n
                    bufs.append(b)
                obj = pickle.loads(head, buffers=bufs)
            self._mail[key] = obj
        elif kind == _K_CHUNK:
            off, total = _CHUNK_META.unpack(arena.read_bytes(pos, head_len))
            pos += head_len
            entry = self._partial.get(key)
            if entry is None:
                entry = self._partial[key] = (bytearray(total), [0])
            blob, got = entry
            for n in lens:
                arena.read_into(pos, memoryview(blob)[off : off + n])
                pos += n
                off += n
                got[0] += n
            if got[0] == total:
                del self._partial[key]
                self._mail[key] = decode_frame(blob)
        else:
            raise RuntimeError(f"unknown shm record kind {kind}")
        arena.tail = pos

    def _poll(self, key: tuple) -> tuple[Any, bool]:
        """One non-blocking claim attempt (drain, then check the box).

        Returns ``(payload-or-_MISSING, drain_progressed)`` — a caller
        parked on an unfinished multi-record payload uses the progress
        bit to stay hot while pieces are still streaming in."""
        with self._lock:
            if key in self._mail:
                return self._mail.pop(key), True
        progressed = self._drain()
        with self._lock:
            return self._mail.pop(key, _MISSING), progressed

    def _set_parked(self, parked: bool) -> None:
        for arena in self._in.values():
            arena.set_parked(parked)

    def _drain_doorbell(self) -> None:
        try:
            while True:
                self._door.recv(16)
        except (BlockingIOError, OSError):
            pass

    def _take(self, key: tuple, tag: Any, timeout: float) -> Any:
        now = time.monotonic()
        deadline = now + timeout
        spin_until = now + self._spin
        pause = _PARK_MIN
        parked = False
        try:
            while True:
                got, progressed = self._poll(key)
                if got is not _MISSING:
                    return got
                now = time.monotonic()
                if now > deadline:
                    src, _, seq = key
                    raise StragglerTimeout(
                        straggler_message(
                            self, f"{tag!r} (seq {seq}) from rank {src}",
                            "shared memory",
                        )
                    )
                if progressed:
                    # records are landing (e.g. a chunked payload
                    # streaming in): stay hot, the producer needs us
                    spin_until = now + self._spin
                    pause = _PARK_MIN
                if now < spin_until:
                    # yield-spin: a message already in flight lands
                    # within a few time slices, no wakeup needed
                    time.sleep(0)
                    continue
                # park: raise the flags, re-drain (a producer that
                # published before seeing a flag is caught here — the
                # lost-wakeup window), then select on the doorbell.  A
                # producer that publishes while a flag is up pokes the
                # doorbell, so the wake is kernel-precise; the timeout
                # only backstops flag races and doubles while the stream
                # stays dry so idle ranks go fully quiet.
                if not parked:
                    self._set_parked(True)
                    parked = True
                got, _ = self._poll(key)
                if got is not _MISSING:
                    return got
                if select.select([self._door], [], [], pause)[0]:
                    self._drain_doorbell()
                    # woken by a publish: lower the flags immediately so
                    # producers stop paying a poke per record while we
                    # drain the burst (a publish that races the next
                    # park is caught by the set-flags-then-repoll above)
                    self._set_parked(False)
                    parked = False
                    spin_until = time.monotonic() + self._spin
                    pause = _PARK_MIN
                else:
                    pause = min(pause * 2, _PARK_MAX)
        finally:
            if parked:
                self._set_parked(False)

    def recv(self, source: int, tag: Any, timeout: float | None = None) -> Any:
        if not (0 <= source < self.np_):
            raise ValueError(f"source {source} out of range for np={self.np_}")
        key = (source, tag_token(tag))
        seq = self._recv_seq.get(key, 0)
        obj = self._take(
            (source, key[1], seq), tag,
            recv_timeout() if timeout is None else timeout,
        )
        self._recv_seq[key] = seq + 1  # commit only after a successful claim
        return obj

    def irecv(self, source: int, tag: Any) -> Request:
        if not (0 <= source < self.np_):
            raise ValueError(f"source {source} out of range for np={self.np_}")
        key = (source, tag_token(tag))
        seq = self._recv_seq.get(key, 0)
        self._recv_seq[key] = seq + 1  # reserve the stream slot now
        return _ShmRecvRequest(self, source, tag, seq)

    def _drop_registration(self, key: tuple) -> None:
        with self._lock:
            self._recv_into_bufs.pop(key, None)

    def irecv_into(self, source: int, tag: Any,
                   buffer: np.ndarray) -> Request:
        """Post a receive completing into ``buffer``; C-contiguous
        buffers are registered with the drain loop, which copies the
        payload bytes from the ring directly into the caller's memory.
        Non-contiguous buffers, chunked payloads, and messages already
        drained land through the generic casting copy instead."""
        if not (0 <= source < self.np_):
            raise ValueError(f"source {source} out of range for np={self.np_}")
        key = (source, tag_token(tag))
        seq = self._recv_seq.get(key, 0)
        self._recv_seq[key] = seq + 1  # reserve the stream slot now
        mkey = (source, key[1], seq)
        if buffer.flags["C_CONTIGUOUS"]:
            with self._lock:
                if mkey not in self._mail:
                    self._recv_into_bufs[mkey] = buffer
        return _ShmRecvIntoRequest(self, source, tag, seq, buffer)

    def probe(self, source: int, tag: Any) -> bool:
        key = (source, tag_token(tag))
        seq = self._recv_seq.get(key, 0)
        mkey = (source, key[1], seq)
        with self._lock:
            if mkey in self._mail:
                return True
        self._drain()
        with self._lock:
            return mkey in self._mail

    # -- elastic restart -------------------------------------------------------

    def _peer_heartbeat(self, peer: int) -> float:
        """``peer``'s latest heartbeat stamp (0.0 when unknowable).

        Read from the mapped outbound arena when one is cached (that ring
        is owned — and beaten — by ``peer``), else from the on-disk
        header of any arena ``peer`` owns."""
        arena = self._out.get(peer)
        if arena is not None:
            try:
                return arena.heartbeat()
            except ValueError:
                return 0.0
        path = self.dir / f"arena_s{self.pid}_d{peer}.ring"
        try:
            with open(path, "rb") as f:
                f.seek(_OFF_HBEAT)
                raw = f.read(_F64.size)
        except OSError:
            return 0.0
        return _F64.unpack(raw)[0] if len(raw) == _F64.size else 0.0

    def dead_ranks(self, max_age: float | None = None) -> list[int]:
        """Peers whose arena heartbeat went stale (liveness contract)."""
        if max_age is None:
            max_age = self._hb_max_age
        now = time.time()
        dead = []
        for peer in range(self.np_):
            if peer == self.pid:
                continue
            hb = self._peer_heartbeat(peer)
            if hb > 0.0 and now - hb > max_age:
                dead.append(peer)
        return dead

    def pending_snapshot(self, limit: int = SNAPSHOT_LIMIT) -> list:
        """Arrived-but-unclaimed (src, tag, seq) matches, bounded."""
        with self._lock:
            return sorted(self._mail.keys())[:limit]

    def epoch_reset(self, peer: int, epoch: int | None = None) -> None:
        """Reset all per-``peer`` stream state at an epoch boundary: the
        restarted incarnation sends and receives from seq 0, so the
        survivor's counters, matching-table residue, half-assembled
        chunk payloads, and pre-registered receive buffers for the dead
        incarnation must all go."""
        if epoch is not None:
            self.epoch = int(epoch)
        for k in [k for k in self._send_seq if k[0] == peer]:
            del self._send_seq[k]
        for k in [k for k in self._recv_seq if k[0] == peer]:
            del self._recv_seq[k]
        with self._lock:
            for k in [k for k in self._mail if k[0] == peer]:
                del self._mail[k]
            for k in [k for k in self._partial if k[0] == peer]:
                del self._partial[k]
            for k in [k for k in self._recv_into_bufs if k[0] == peer]:
                del self._recv_into_bufs[k]

    # -- lifecycle -------------------------------------------------------------

    def finalize(self) -> None:
        self._closed = True
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=1.0)
            self._hb_thread = None
        for arena in self._out.values():
            arena.close()
        self._out.clear()
        for arena in self._in.values():
            arena.close()
            try:
                os.unlink(arena.path)
            except OSError:
                pass
        self._in.clear()
        addr = _doorbell_address(self.dir, self.pid)
        try:
            self._door.close()
        except OSError:
            pass
        if not addr.startswith("\0"):
            try:
                os.unlink(addr)
            except OSError:
                pass
