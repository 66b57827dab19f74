"""FileMPI: the paper's file-based PythonMPI transport (paper §III.D).

Messages are pickled to a shared directory and claimed by the receiver:

* ``send`` writes ``<dir>/m_s<src>_d<dst>_q<seq>_<tag>.tmp`` then atomically
  renames it to ``.buf`` — the rename is the "message posted" event, so a
  reader can never observe a half-written payload.
* ``recv`` polls for the expected ``.buf`` (per-(src,tag) sequence numbers
  give FIFO ordering and let tags repeat), unpickles, and deletes it.
* sends are **one-sided**: posting never waits for a matching receive, and
  an unclaimed message sits on disk where it can be inspected — the paper's
  debugging affordance.

The paper initially serialized via h5py/HDF5 but switched to pickle because
h5py cannot store complex NumPy arrays; we go straight to pickle (protocol
5, zero-copy buffers for large arrays).

Straggler handling beyond the paper: receives carry a deadline
(``PPYTHON_RECV_TIMEOUT``, default 300 s) and every rank refreshes a
heartbeat file; ``dead_ranks()`` surfaces peers whose heartbeat went stale
so the launcher can restart them from the last checkpoint.

The port's own copy of ``repro.comm.filempi`` (NumPy only), for the checkpoint's
``Dmat`` paths; it differs from the original in its docstrings alone.
"""

from __future__ import annotations

import mmap
import os
import pickle
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np

from .context import (
    CommContext,
    Request,
    StragglerTimeout,
    land_into as _land_into,
    recv_timeout,
    run_epoch,
)
from .liveness import SNAPSHOT_LIMIT, straggler_message
from .frame import (
    FLAG_CHUNKED as _FLAG_CHUNKED,
    ChunkHeader as _ChunkHeader,
    decode_frame as _decode_frame,
    encode_frame as _encode_frame,
    max_msg_bytes as _max_msg_bytes,
    read_footer as _read_footer,
    read_trailer as _read_trailer,
    tag_token as _tag_token,
)

__all__ = ["FileMPI"]

_POLL_MIN = 0.0005
_POLL_MAX = 0.05
HEARTBEAT_PERIOD = 5.0

# Frame layout (see comm/frame.py, shared with SocketComm): pickle bytes
# first, then the raw out-of-band buffers, then a fixed trailer.  Large
# array payloads travel as raw bytes — never re-encoded into the pickle
# stream — and the whole message is one file and ONE fsync.  The flag
# byte marks chunk-header frames so ``probe`` can classify a pending
# message from the 17-byte footer alone.


class _FileRecvRequest(Request):
    """Receive handle bound to a reserved (source, tag, seq) slot."""

    def __init__(self, ctx: "FileMPI", source: int, tag: Any, seq: int):
        self._ctx = ctx
        self._source = source
        self._tag = tag
        self._seq = seq
        self._done = False
        self._value: Any = None

    def _claim(self) -> Any:
        """One non-blocking claim attempt (into-variant overrides)."""
        return self._ctx._try_claim(self._source, self._tag, self._seq)

    def test(self) -> bool:
        if not self._done:
            got = self._claim()
            if got is not _NOT_READY:
                self._value = got
                self._done = True
        return self._done

    def wait(self, timeout: float | None = None) -> Any:
        if self._done:
            return self._value
        deadline = time.monotonic() + (
            recv_timeout() if timeout is None else timeout
        )
        pause = _POLL_MIN
        while not self.test():
            if time.monotonic() > deadline:
                raise StragglerTimeout(
                    straggler_message(
                        self._ctx,
                        f"{self._tag!r} (seq {self._seq}) from rank "
                        f"{self._source}",
                        "the shared directory",
                    )
                )
            time.sleep(pause)
            pause = min(pause * 2, _POLL_MAX)
        return self._value


_NOT_READY = object()


class _FileRecvIntoRequest(_FileRecvRequest):
    """Receive handle that decodes the claimed frame *into* a caller
    buffer — ``_FileRecvRequest`` with only the claim step overridden
    (the poll/backoff/straggler machinery is shared)."""

    def __init__(self, ctx: "FileMPI", source: int, tag: Any, seq: int,
                 buffer: np.ndarray):
        super().__init__(ctx, source, tag, seq)
        self._buffer = buffer

    def _claim(self) -> Any:
        return self._ctx._try_claim_into(
            self._source, self._tag, self._seq, self._buffer
        )


class FileMPI(CommContext):
    def __init__(self, np_: int, pid: int, comm_dir: str | os.PathLike,
                 heartbeat: bool = True, epoch: int | None = None):
        if not (0 <= pid < np_):
            raise ValueError(f"pid {pid} out of range for np={np_}")
        self.np_ = np_
        self.pid = pid
        self.epoch = run_epoch() if epoch is None else int(epoch)
        # epoch > 0 tokens every message filename: a gang-restarted world
        # sharing the comm dir can never claim a dead generation's
        # residue (epoch 0 keeps the paper's plain layout)
        self._etok = f"E{self.epoch}_" if self.epoch > 0 else ""
        self.dir = Path(comm_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._send_seq: dict[tuple[int, str], int] = {}
        # next unreserved receive seq per (source, tag): blocking ``recv``
        # commits it only after the message is claimed, so a
        # StragglerTimeout leaves the stream position unchanged and a
        # retry matches the same message; ``irecv`` reserves eagerly so
        # several receives can be outstanding on one stream.
        self._recv_seq: dict[tuple[int, str], int] = {}
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        if heartbeat:
            self._start_heartbeat()

    # -- point to point -------------------------------------------------------

    def _msg_path(self, src: int, dst: int, tag: Any, seq: int) -> Path:
        return self.dir / (
            f"m_s{src}_d{dst}_q{seq}_{self._etok}{_tag_token(tag)}.buf"
        )

    def _publish(self, final: Path, parts: list) -> None:
        """Write ``parts`` to a temp file, fsync once, atomically rename."""
        tmp = final.with_suffix(f".tmp{os.getpid()}_{threading.get_ident()}")
        with open(tmp, "wb") as f:
            for p in parts:
                f.write(p)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)  # atomic publish

    def send(self, dest: int, tag: Any, obj: Any) -> None:
        if not (0 <= dest < self.np_):
            raise ValueError(f"dest {dest} out of range for np={self.np_}")
        key = (dest, _tag_token(tag))
        seq = self._send_seq.get(key, 0)
        self._send_seq[key] = seq + 1
        parts = _encode_frame(obj)
        total = sum(len(p) for p in parts)
        limit = _max_msg_bytes()
        if limit and total > limit:
            # Oversize payload: publish a chunk header on the main stream,
            # then the raw frame bytes as <= limit pieces on a side stream
            # derived from (tag, seq) — the main stream stays one seq per
            # message, so outstanding irecvs never skew.
            blob = b"".join(parts)
            nchunks = -(-len(blob) // limit)
            self._publish(
                self._msg_path(self.pid, dest, tag, seq),
                _encode_frame(_ChunkHeader(nchunks, len(blob)),
                              flags=_FLAG_CHUNKED),
            )
            for i in range(nchunks):
                self._publish(
                    self._msg_path(self.pid, dest, ("__chunk", tag, seq), i),
                    [blob[i * limit : (i + 1) * limit]],
                )
            return
        self._publish(self._msg_path(self.pid, dest, tag, seq), parts)

    @staticmethod
    def _map_file(path: Path):
        """Copy-on-write mmap of a published message file: array payloads
        alias the mapped pages (zero-copy read, still writable), and once
        the file is unlinked its pages live until the arrays referencing
        them are garbage collected."""
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            return mmap.mmap(f.fileno(), size, access=mmap.ACCESS_COPY)

    def _try_claim(self, source: int, tag: Any, seq: int) -> Any:
        """One non-blocking, all-or-nothing claim attempt.

        Returns ``_NOT_READY`` unless the message — including every chunk
        piece of an oversize payload — is fully present; nothing is
        unlinked until the object is decoded, so a timeout (or a sender
        dying mid-chunk) leaves the stream intact for a later retry.
        """
        path = self._msg_path(source, self.pid, tag, seq)
        if not path.exists():
            return _NOT_READY
        try:
            obj = _decode_frame(self._map_file(path))
        except FileNotFoundError:  # lost a race with another local thread
            return _NOT_READY
        if not isinstance(obj, _ChunkHeader):
            os.unlink(path)
            return obj
        chunks = [
            self._msg_path(source, self.pid, ("__chunk", tag, seq), i)
            for i in range(obj.nchunks)
        ]
        if not all(p.exists() for p in chunks):
            return _NOT_READY  # pieces still in flight; claim nothing
        # reassemble straight into one writable buffer: no per-piece
        # intermediate copies, and the decoded arrays stay mutable (bytes
        # would hand pickle read-only views)
        blob = bytearray(obj.total)
        view = memoryview(blob)
        off = 0
        for p in chunks:
            with open(p, "rb") as f:
                while off < obj.total:
                    n = f.readinto(view[off:])
                    if not n:
                        break
                    off += n
        if off != obj.total:
            raise ValueError(
                f"chunked payload reassembled to {off} bytes, "
                f"expected {obj.total}"
            )
        out = _decode_frame(blob)
        os.unlink(path)
        for p in chunks:
            os.unlink(p)
        return out

    def recv(self, source: int, tag: Any, timeout: float | None = None) -> Any:
        if not (0 <= source < self.np_):
            raise ValueError(f"source {source} out of range for np={self.np_}")
        key = (source, _tag_token(tag))
        seq = self._recv_seq.get(key, 0)
        deadline = time.monotonic() + (
            recv_timeout() if timeout is None else timeout
        )
        pause = _POLL_MIN
        while True:
            obj = self._try_claim(source, tag, seq)
            if obj is not _NOT_READY:
                self._recv_seq[key] = seq + 1  # commit only after the claim
                return obj
            if time.monotonic() > deadline:
                raise StragglerTimeout(
                    straggler_message(
                        self, f"{tag!r} (seq {seq}) from rank {source}",
                        "the shared directory",
                    )
                )
            time.sleep(pause)
            pause = min(pause * 2, _POLL_MAX)

    def irecv(self, source: int, tag: Any) -> Request:
        if not (0 <= source < self.np_):
            raise ValueError(f"source {source} out of range for np={self.np_}")
        key = (source, _tag_token(tag))
        seq = self._recv_seq.get(key, 0)
        self._recv_seq[key] = seq + 1  # reserve the stream slot now
        return _FileRecvRequest(self, source, tag, seq)

    def _try_claim_into(self, source: int, tag: Any, seq: int,
                        buffer: np.ndarray) -> Any:
        """One non-blocking claim attempt that lands the payload in
        ``buffer``.

        When the published frame is a single-ndarray message whose raw
        bytes match the buffer exactly, those bytes are ``readinto`` the
        buffer and the pickle head reconstructs the array over the
        caller's memory — the message never touches an intermediate
        allocation.  Chunked headers, multi-buffer payloads, size or
        contiguity mismatches fall back to the general claim followed by
        a casting copy (``land_into``), so the contract always holds.
        """
        path = self._msg_path(source, self.pid, tag, seq)
        if not path.exists():
            return _NOT_READY
        trailer = _read_trailer(path)
        fast = (
            trailer is not None
            and not trailer[2] & _FLAG_CHUNKED
            and len(trailer[1]) == 1
            and buffer.flags["C_CONTIGUOUS"]
            and trailer[1][0] == buffer.nbytes
        )
        if not fast:
            got = self._try_claim(source, tag, seq)
            if got is _NOT_READY:
                return _NOT_READY
            return _land_into(buffer, got)
        head_len = trailer[0]
        mv = memoryview(buffer).cast("B")
        try:
            with open(path, "rb") as f:
                head = f.read(head_len)
                got = 0
                while got < len(mv):
                    n = f.readinto(mv[got:])
                    if not n:
                        break
                    got += n
        except FileNotFoundError:  # lost a race with another local thread
            return _NOT_READY
        if len(head) != head_len or got != len(mv):
            return _NOT_READY  # torn read: retry on the next poll
        obj = pickle.loads(head, buffers=[mv])
        os.unlink(path)
        return _land_into(buffer, obj)

    def irecv_into(self, source: int, tag: Any,
                   buffer: np.ndarray) -> Request:
        if not (0 <= source < self.np_):
            raise ValueError(f"source {source} out of range for np={self.np_}")
        key = (source, _tag_token(tag))
        seq = self._recv_seq.get(key, 0)
        self._recv_seq[key] = seq + 1  # reserve the stream slot now
        return _FileRecvIntoRequest(self, source, tag, seq, buffer)

    def probe(self, source: int, tag: Any) -> bool:
        """True only when the next message is *fully* claimable — for a
        chunked payload that means the header and every piece, so a probe
        hit guarantees the matching recv does not block on the sender.

        Cost: one 17-byte footer read; only a chunk *header* (a tiny
        frame) is ever decoded here, never a payload."""
        key = (source, _tag_token(tag))
        seq = self._recv_seq.get(key, 0)
        path = self._msg_path(source, self.pid, tag, seq)
        if not path.exists():
            return False
        foot = _read_footer(path)
        if foot is None:
            return False
        if not foot[2] & _FLAG_CHUNKED:
            return True
        try:
            hdr = _decode_frame(self._map_file(path))
        except (FileNotFoundError, ValueError):
            return False
        return all(
            self._msg_path(source, self.pid, ("__chunk", tag, seq), i).exists()
            for i in range(hdr.nchunks)
        )

    # -- broadcast: single payload file, reference-counted --------------------

    def onefile_bcast(self, root: int, obj: Any, tag: Any, ranks) -> Any:
        """One-file broadcast: the payload is written once and every receiver
        reads it in place (MatlabMPI's trick); receivers drop a done-marker
        and the last one reclaims the payload.

        ``ranks`` is the participating world-pid set — the collectives
        layer routes any ``Group.bcast`` here (the transport hook the
        algorithm selector prefers on FileMPI), so reclaim counts group
        readers, not world size."""
        ranks = tuple(ranks)
        if len(ranks) == 1:
            return obj
        key = ("__bc", _tag_token(tag))
        seq = self._send_seq.get(key, 0)
        self._send_seq[key] = seq + 1
        payload = self.dir / (
            f"bc_r{root}_q{seq}_{self._etok}{_tag_token(tag)}.buf"
        )
        if self.pid == root:
            self._publish(payload, _encode_frame(obj))
            return obj
        deadline = time.monotonic() + recv_timeout()
        pause = _POLL_MIN
        while not payload.exists():
            if time.monotonic() > deadline:
                raise StragglerTimeout(
                    f"rank {self.pid} timed out on bcast {tag!r} from {root}"
                )
            time.sleep(pause)
            pause = min(pause * 2, _POLL_MAX)
        obj = _decode_frame(self._map_file(payload))
        done = payload.with_suffix(f".done{self.pid}")
        done.touch()
        # last reader reclaims payload + markers (best-effort)
        markers = list(self.dir.glob(payload.stem + ".done*"))
        if len(markers) >= len(ranks) - 1:
            for m in markers + [payload]:
                try:
                    os.unlink(m)
                except FileNotFoundError:
                    pass
        return obj

    # -- liveness ---------------------------------------------------------------

    def _hb_path(self, pid: int) -> Path:
        return self.dir / f"hb_{pid}"

    def _start_heartbeat(self) -> None:
        def beat() -> None:
            while not self._hb_stop.wait(HEARTBEAT_PERIOD):
                try:
                    self._hb_path(self.pid).touch()
                except OSError:
                    pass

        self._hb_path(self.pid).touch()
        self._hb_thread = threading.Thread(target=beat, daemon=True)
        self._hb_thread.start()

    def dead_ranks(self, max_age: float = 4 * HEARTBEAT_PERIOD) -> list[int]:
        """Ranks whose heartbeat file is stale (or missing after startup)."""
        now = time.time()
        dead = []
        for pid in range(self.np_):
            if pid == self.pid:
                continue
            p = self._hb_path(pid)
            try:
                if now - p.stat().st_mtime > max_age:
                    dead.append(pid)
            except FileNotFoundError:
                dead.append(pid)
        return dead

    def pending_snapshot(self, limit: int = SNAPSHOT_LIMIT) -> list:
        """Arrived-but-unclaimed inbound message files, bounded — the
        on-disk matching table the paper advertises as its debugging
        affordance, surfaced through the liveness contract."""
        names = sorted(
            p.name for p in self.dir.glob(f"m_*_d{self.pid}_*.buf")
        )
        return names[:limit]

    def epoch_reset(self, peer: int, epoch: int | None = None) -> None:
        """Reset per-``peer`` stream state at an epoch boundary.  On-disk
        residue needs no sweep: epoch-tokened filenames already fence a
        dead generation's messages out of the new one's matching."""
        if epoch is not None:
            self.epoch = int(epoch)
            self._etok = f"E{self.epoch}_" if self.epoch > 0 else ""
        for k in [k for k in self._send_seq if k[0] == peer]:
            del self._send_seq[k]
        for k in [k for k in self._recv_seq if k[0] == peer]:
            del self._recv_seq[k]

    def finalize(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=1.0)
        try:
            os.unlink(self._hb_path(self.pid))
        except FileNotFoundError:
            pass
