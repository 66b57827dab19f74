"""SocketComm: peer-to-peer TCP transport — multi-node pPython without a
shared filesystem.

The paper's PythonMPI moves every message through a pickle file on a
shared directory: a round trip pays serialization, an fsync, an atomic
rename, and the receiver's poll loop — and the whole design caps pPython
at clusters that *have* a shared filesystem.  SocketComm keeps the exact
transport contract the algorithm layer was written against (one-sided
``send``, per-(src, tag) FIFO sequence streams, ``probe``/``irecv``
request semantics, ``PPYTHON_MAX_MSG_BYTES`` chunking) and replaces the
filesystem with persistent TCP connections:

* **Connections are simplex and persistent.**  The first send to a peer
  dials that peer's advertised endpoint, says HELLO (the sender's rank),
  and keeps the connection for the rest of the run; the dialing side
  only ever writes, the accepting side only ever reads.  Two ranks that
  message both ways hold two sockets — no duplex handshake races, and
  TCP's in-order delivery gives each (src, dst) pair a FIFO wire for
  free.
* **Framing is length-prefixed pickle-5 with out-of-band buffers.**  A
  message record carries the pickle head plus each raw buffer's length
  in its header; the receiver reads every ndarray payload straight into
  its own freshly allocated buffer with ``recv_into`` and hands those
  buffers to ``pickle.loads`` — arrays are reconstructed over the
  received bytes with **zero re-copy** (and stay writable, unlike a
  ``bytes``-backed load).
* **A background receiver thread per connection** decodes records and
  posts them into a (src, tag, seq)-keyed matching table with targeted
  per-key wakeups (the same ``ThreadWorld`` mailbox ThreadComm uses), so
  a blocked ``recv`` sleeps on an event instead of polling a directory.
* **Oversize payloads chunk at ``PPYTHON_MAX_MSG_BYTES``** exactly like
  FileMPI: the flat frame (``comm/frame.py``) is split into bounded
  pieces, each a CHUNK record carrying its byte offset; the receiver
  assembles them into one preallocated buffer and decodes when the last
  piece lands, so a rank's memory high-water mark per in-flight message
  is one payload, never payload + wire copies.

Bootstrap is rendezvous-based (``comm/rendezvous.py``): every rank binds
an ephemeral listener, learns its ``(host, port)``, and exchanges the
endpoint table either through a rank-0 TCP rendezvous server
(``PPYTHON_RDZV_ADDR`` — the no-shared-filesystem path) or a one-time
file exchange.  ``SocketComm.bootstrap()`` is what ``init()`` calls when
``PPYTHON_TRANSPORT=socket``.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
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
from .liveness import SNAPSHOT_LIMIT, straggler_message
from .frame import (
    chunk_windows,
    decode_frame,
    encode_frame,
    max_msg_bytes,
    oob_buffers,
    tag_token,
)
from .rendezvous import advertised_host, bind_listener, exchange_endpoints
from .threadcomm import ThreadWorld, _MISSING

__all__ = ["SocketComm"]

# Record header: magic, kind, tag token length, seq, head length, nbuf.
# Followed by nbuf u64 buffer lengths, the tag token, the head bytes, and
# the raw buffers.  MSG heads are pickle-5 streams referencing the raw
# buffers out-of-band; CHUNK heads are a (offset, total) struct and carry
# exactly one raw buffer (the piece).
_HDR = struct.Struct("<4sBIQQI")
_CHUNK_META = struct.Struct("<QQ")
_MAGIC = b"PPS1"
_K_HELLO = 0
_K_MSG = 1
_K_CHUNK = 2

_DIAL_RETRY = 0.02


class _SocketRecvRequest(Request):
    """Receive handle bound to a reserved (source, tag, seq) slot."""

    def __init__(self, ctx: "SocketComm", source: int, tag: Any, seq: int):
        self._ctx = ctx
        self._key = (source, tag_token(tag), seq)
        self._tag = tag
        self._done = False
        self._value: Any = None

    def test(self) -> bool:
        if not self._done:
            got = self._ctx._mail.take_nowait(self._key)
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


class _SocketRecvIntoRequest(Request):
    """Receive handle bound to a reserved (source, tag, seq) slot that
    completes into a caller buffer.

    The buffer was pre-registered with the wire reader at post time; if
    the reader matched it, the payload already sits in caller memory and
    ``land_into`` is a no-op.  If the message raced ahead of the post
    (or didn't match), the payload is landed with a copy and the stale
    registration is dropped.
    """

    def __init__(self, ctx: "SocketComm", source: int, tag: Any, seq: int,
                 buffer: np.ndarray):
        self._ctx = ctx
        self._key = (source, tag_token(tag), seq)
        self._tag = tag
        self._buffer = buffer
        self._done = False

    def _finish(self, payload: Any) -> None:
        self._ctx._drop_registration(self._key)
        _land_into(self._buffer, payload)
        self._done = True

    def test(self) -> bool:
        if not self._done:
            got = self._ctx._mail.take_nowait(self._key)
            if got is not _MISSING:
                self._finish(got)
        return self._done

    def wait(self, timeout: float | None = None) -> Any:
        if not self._done:
            try:
                got = self._ctx._take(
                    self._key, self._tag,
                    recv_timeout() if timeout is None else timeout,
                )
            except StragglerTimeout:
                # the caller is about to give up on this receive: drop
                # the registration so a late-arriving message decodes
                # into its own fresh buffer instead of being recv_into'd
                # over caller memory the application may have moved on to
                self._ctx._drop_registration(self._key)
                raise
            self._finish(got)
        return self._buffer


class SocketComm(CommContext):
    """TCP rank endpoint over a rendezvous-exchanged peer table.

    ``endpoints`` is the rank-ordered ``(host, port)`` table; ``listener``
    is this rank's already-bound listening socket (bound *before* the
    endpoint exchange so the advertised port is live by the time any peer
    learns it).  Use :meth:`bootstrap` to do bind + rendezvous + construct
    in one step.
    """

    def __init__(
        self,
        np_: int,
        pid: int,
        endpoints: list[tuple[str, int]],
        listener: socket.socket,
        epoch: int | None = None,
    ):
        if not (0 <= pid < np_):
            raise ValueError(f"pid {pid} out of range for np={np_}")
        if len(endpoints) != np_:
            raise ValueError(
                f"endpoint table has {len(endpoints)} entries for np={np_}"
            )
        self.np_ = np_
        self.pid = pid
        self.epoch = run_epoch() if epoch is None else int(epoch)
        self.endpoints = [tuple(e) for e in endpoints]
        # elastic-restart state: peers whose connection died abortively
        # (mid-record EOF / ECONNRESET — a clean between-records close is
        # a finalize, not a death), stale-generation HELLOs refused, and
        # an optional hook the supervisor can install to re-resolve a
        # restarted peer's endpoint before a redial
        self._dead: set[int] = set()
        self._stale_hellos = 0
        self._refresh_endpoint = None  # dest -> fresh (host, port) | None
        self._send_seq: dict[tuple[int, str], int] = {}
        # next unreserved receive seq per (source, tag): blocking ``recv``
        # commits it only after the message is claimed (a StragglerTimeout
        # leaves the stream position unchanged); ``irecv`` reserves
        # eagerly so several receives can be outstanding on one stream.
        self._recv_seq: dict[tuple[int, str], int] = {}
        # matching table: (src, tag_token, seq) -> decoded payload, with
        # per-key targeted wakeups (reused from ThreadComm's fabric)
        self._mail = ThreadWorld(np_)
        # irecv_into pre-registrations: (src, tag_token, seq) -> caller
        # buffer the wire reader should recv_into directly.  Guarded by
        # its own lock; a registration that loses the race with an
        # already-decoded message is dropped at request completion.
        self._recv_into_bufs: dict[tuple, np.ndarray] = {}
        self._reg_lock = threading.Lock()
        self._peers: dict[int, socket.socket] = {}
        self._peer_locks: dict[int, threading.Lock] = {}
        self._peers_guard = threading.Lock()
        self._closed = threading.Event()
        self._rx_error: BaseException | None = None
        self._readers: list[threading.Thread] = []
        self._listener = listener
        self._listener.settimeout(0.2)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"ppsock-accept-{pid}", daemon=True
        )
        self._accept_thread.start()

    # -- bootstrap -----------------------------------------------------------

    @classmethod
    def bootstrap(
        cls,
        np_: int,
        pid: int,
        *,
        rdzv_addr: str | None = None,
        rdzv_dir: str | os.PathLike | None = None,
        host: str | None = None,
        timeout: float | None = None,
        epoch: int | None = None,
    ) -> "SocketComm":
        """Bind an ephemeral listener, rendezvous the endpoint table, and
        return a connected context — the ``PPYTHON_TRANSPORT=socket``
        entry point used by ``init()`` and the launchers."""
        host = host or advertised_host()
        listener = bind_listener("")
        port = listener.getsockname()[1]
        try:
            endpoints = exchange_endpoints(
                np_, pid, (host, port),
                addr=rdzv_addr, rdzv_dir=rdzv_dir, timeout=timeout,
                epoch=epoch,
            )
        except BaseException:
            listener.close()
            raise
        return cls(np_, pid, endpoints, listener, epoch=epoch)

    # -- connection management ----------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us: finalize() ran
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._reader_loop, args=(conn,),
                name=f"ppsock-rx-{self.pid}", daemon=True,
            )
            t.start()
            self._readers.append(t)

    def _peer_sock(
        self, dest: int, deadline: float | None = None,
    ) -> tuple[socket.socket, threading.Lock]:
        """Persistent simplex connection to ``dest`` (dial on first use).

        The dial loop retries with capped exponential backoff; each retry
        consults the ``_refresh_endpoint`` hook (when installed) so a
        peer restarted onto a fresh ephemeral port is re-resolved rather
        than dialed at its ghost's address.  The HELLO carries this
        rank's epoch — a restarted receiver refuses HELLOs from dead
        generations."""
        with self._peers_guard:
            sock = self._peers.get(dest)
            if sock is not None:
                return sock, self._peer_locks[dest]
            lock = self._peer_locks.setdefault(dest, threading.Lock())
        if deadline is None:
            deadline = time.monotonic() + recv_timeout()
        backoff = _DIAL_RETRY
        while True:
            host, port = self.endpoints[dest]
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.settimeout(max(0.5, deadline - time.monotonic()))
                s.connect((host, port))
                break
            except OSError as e:
                s.close()
                if time.monotonic() > deadline or self._closed.is_set():
                    raise StragglerTimeout(
                        f"rank {self.pid} could not connect to rank {dest} "
                        f"at {host}:{port}: {e}"
                    ) from None
                self._maybe_refresh(dest)
                time.sleep(backoff)
                backoff = min(backoff * 2, 1.0)
        s.settimeout(None)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.sendall(_HDR.pack(_MAGIC, _K_HELLO, 0, self.pid, self.epoch, 0))
        with self._peers_guard:
            won = self._peers.setdefault(dest, s)
        if won is not s:  # lost a concurrent-dial race: use the winner
            s.close()
        return won, lock

    def _maybe_refresh(self, dest: int) -> None:
        """Re-resolve ``dest``'s endpoint through the supervisor hook."""
        refresh = self._refresh_endpoint
        if refresh is None:
            return
        try:
            ep = refresh(dest)
        except Exception:
            return  # best-effort: keep dialing the known endpoint
        if ep:
            self.endpoints[dest] = tuple(ep)

    def _invalidate_peer(self, dest: int) -> None:
        """Drop (and close) the cached connection to ``dest``."""
        with self._peers_guard:
            s = self._peers.pop(dest, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    # -- send path ------------------------------------------------------------

    def _record(self, kind: int, tag_tok: bytes, seq: int, head: bytes,
                raws: list) -> list:
        parts = [
            _HDR.pack(_MAGIC, kind, len(tag_tok), seq, len(head), len(raws)),
            struct.pack(f"<{len(raws)}Q", *[len(r) for r in raws]),
            tag_tok,
            head,
        ]
        parts.extend(raws)
        return parts

    def _send_record(self, dest: int, parts: list) -> None:
        """Write one record, redialing through restarts.

        A mid-send OSError means the connection died (the peer crashed or
        was restarted).  The cached socket is invalidated, ``dest`` is
        marked dead, and the record is re-sent over a fresh dial —
        bounded by the recv-timeout budget.  Re-sending a full record is
        safe: the dead incarnation's partial bytes died with its reader,
        and the restarted incarnation starts a fresh stream."""
        deadline = time.monotonic() + recv_timeout()
        redialed = False
        while True:
            sock, lock = self._peer_sock(dest, deadline=deadline)
            with lock:
                try:
                    # coalesce the small leading parts into one segment;
                    # big raw buffers go straight from their exporter's
                    # memory
                    small = b"".join(
                        bytes(p) for p in parts[:4]
                    )
                    sock.sendall(small)
                    for p in parts[4:]:
                        sock.sendall(p)
                    if redialed:
                        self._dead.discard(dest)
                    return
                except OSError as e:
                    err = e
            self._invalidate_peer(dest)
            self._dead.add(dest)
            if self._closed.is_set() or time.monotonic() > deadline:
                raise StragglerTimeout(
                    f"rank {self.pid} lost its connection to rank {dest} "
                    f"and could not re-establish it: {err}"
                ) from None
            redialed = True
            self._maybe_refresh(dest)
            _metrics.counter("elastic.socket_redials").inc()

    def send(self, dest: int, tag: Any, obj: Any) -> None:
        if not (0 <= dest < self.np_):
            raise ValueError(f"dest {dest} out of range for np={self.np_}")
        tok_str = tag_token(tag)
        tok = tok_str.encode()
        key = (dest, tok_str)
        seq = self._send_seq.get(key, 0)
        self._send_seq[key] = seq + 1
        limit = max_msg_bytes()
        if limit:
            # one serialization either way: the flat frame is both the
            # size probe and (when oversize) the chunked wire payload
            parts = encode_frame(obj)
            total = sum(len(p) for p in parts)
            if total > limit:
                # oversize: stream the flat frame as <= limit CHUNK
                # records on the same (tag, seq); the receiver assembles
                # into one preallocated buffer and decodes on completion
                for off, slices in chunk_windows(parts, limit):
                    self._send_record(
                        dest,
                        self._record(_K_CHUNK, tok, seq,
                                     _CHUNK_META.pack(off, total), slices),
                    )
                return
            head, raws = parts[0], parts[1:-2]
        else:
            head, raws = oob_buffers(obj)
        self._send_record(dest, self._record(_K_MSG, tok, seq, head, raws))

    # -- receive path ----------------------------------------------------------

    @staticmethod
    def _read_into(sock: socket.socket, view: memoryview) -> None:
        """Fill ``view`` exactly; raises on EOF (caller is mid-record)."""
        got = 0
        n = len(view)
        while got < n:
            k = sock.recv_into(view[got:])
            if k == 0:
                raise ConnectionError("peer closed mid-record")
            got += k

    @classmethod
    def _read_new(cls, sock: socket.socket, n: int) -> memoryview:
        """Read exactly ``n`` bytes into a fresh writable buffer."""
        view = memoryview(bytearray(n))
        cls._read_into(sock, view)
        return view

    def _reader_loop(self, conn: socket.socket) -> None:
        """Decode records off one accepted connection and post payloads
        into the matching table.  Chunk reassembly is local to the
        connection: all pieces of one message arrive in order on the
        sender's single simplex socket."""
        src = -1
        partial: dict[tuple, tuple[bytearray, list]] = {}
        hdr_buf = memoryview(bytearray(_HDR.size))
        try:
            with conn:
                while not self._closed.is_set():
                    # EOF *between* records is the peer finalizing cleanly
                    first = conn.recv_into(hdr_buf)
                    if first == 0:
                        return
                    self._read_into(conn, hdr_buf[first:])
                    magic, kind, tag_len, seq, head_len, nbuf = (
                        _HDR.unpack(hdr_buf)
                    )
                    if magic != _MAGIC:
                        raise ValueError(f"bad record magic {bytes(magic)!r}")
                    if kind == _K_HELLO:
                        # the HELLO reuses the head_len field to carry
                        # the dialer's epoch; a ghost of a dead
                        # generation is refused outright — its connection
                        # closes and it can never post into this
                        # generation's matching table
                        if head_len < self.epoch:
                            self._stale_hellos += 1
                            _metrics.counter("elastic.stale_hellos").inc()
                            return
                        src = seq
                        continue
                    lens = struct.unpack(
                        f"<{nbuf}Q", self._read_new(conn, 8 * nbuf)
                    )
                    tok = bytes(self._read_new(conn, tag_len)).decode()
                    head = self._read_new(conn, head_len)
                    if kind == _K_MSG:
                        # single-buffer payloads matching a pre-registered
                        # irecv_into buffer are recv_into'd straight into
                        # the caller's memory; everything else lands in
                        # its own fresh writable buffer via recv_into and
                        # pickle reconstructs arrays over those bytes —
                        # zero re-copy on receive either way
                        key = (src, tok, seq)
                        target = None
                        if nbuf == 1:
                            with self._reg_lock:
                                reg = self._recv_into_bufs.get(key)
                                if (reg is not None
                                        and reg.nbytes == lens[0]):
                                    target = self._recv_into_bufs.pop(key)
                        if target is not None:
                            mv = memoryview(target).cast("B")
                            self._read_into(conn, mv)
                            obj = pickle.loads(head, buffers=[mv])
                        else:
                            bufs = [self._read_new(conn, n) for n in lens]
                            obj = pickle.loads(head, buffers=bufs)
                        self._mail.post(key, obj)
                        continue
                    if kind != _K_CHUNK:
                        raise ValueError(f"unknown record kind {kind}")
                    off, total = _CHUNK_META.unpack(head)
                    entry = partial.get((tok, seq))
                    if entry is None:
                        entry = partial[(tok, seq)] = (bytearray(total), [0])
                    blob, got = entry
                    # pieces land straight in the assembly buffer at their
                    # offsets — no per-piece intermediate allocation (one
                    # record may carry several slices of the flat frame)
                    for n in lens:
                        self._read_into(
                            conn, memoryview(blob)[off : off + n]
                        )
                        off += n
                        got[0] += n
                    if got[0] == total:
                        del partial[(tok, seq)]
                        self._mail.post((src, tok, seq), decode_frame(blob))
        except (OSError, ConnectionError, ValueError, struct.error) as e:
            if not self._closed.is_set():
                self._rx_error = e
                if src >= 0:
                    # abortive death mid-record: the sender crashed (a
                    # clean between-records EOF returns above instead)
                    self._dead.add(src)

    def _take(self, key: tuple, tag: Any, timeout: float) -> Any:
        try:
            return self._mail.take(key, timeout)
        except StragglerTimeout:
            src, _, seq = key
            extra = (f"; receiver error: {self._rx_error}"
                     if self._rx_error else "")
            raise StragglerTimeout(
                straggler_message(
                    self, f"{tag!r} (seq {seq}) from rank {src}", "TCP",
                    extra=extra,
                )
            ) from None

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
        return _SocketRecvRequest(self, source, tag, seq)

    def _drop_registration(self, key: tuple) -> None:
        with self._reg_lock:
            self._recv_into_bufs.pop(key, None)

    def irecv_into(self, source: int, tag: Any,
                   buffer: np.ndarray) -> Request:
        """Post a receive completing into ``buffer``; when the buffer is
        C-contiguous it is registered with the wire reader, which
        ``recv_into``\\ s the payload bytes straight off the socket into
        the caller's memory (no intermediate allocation).  Non-contiguous
        buffers, chunked payloads, and messages that arrived before the
        post land through the generic copy instead."""
        if not (0 <= source < self.np_):
            raise ValueError(f"source {source} out of range for np={self.np_}")
        key = (source, tag_token(tag))
        seq = self._recv_seq.get(key, 0)
        self._recv_seq[key] = seq + 1  # reserve the stream slot now
        mkey = (source, key[1], seq)
        if buffer.flags["C_CONTIGUOUS"] and not self._mail.peek(mkey):
            with self._reg_lock:
                self._recv_into_bufs[mkey] = buffer
        return _SocketRecvIntoRequest(self, source, tag, seq, buffer)

    def probe(self, source: int, tag: Any) -> bool:
        key = (source, tag_token(tag))
        seq = self._recv_seq.get(key, 0)
        return self._mail.peek((source, key[1], seq))

    # -- elastic restart -------------------------------------------------------

    def dead_ranks(self) -> list[int]:
        """Peers whose connection died abortively (liveness contract)."""
        return sorted(self._dead)

    def pending_snapshot(self, limit: int = SNAPSHOT_LIMIT) -> list:
        """Arrived-but-unclaimed (src, tag, seq) matches, bounded."""
        return sorted(self._mail.keys())[:limit]

    def epoch_reset(self, peer: int, epoch: int | None = None) -> None:
        """Reset all per-``peer`` stream state at an epoch boundary: the
        restarted incarnation sends and receives from seq 0, so the
        survivor's counters, cached connection, matching-table residue,
        and pre-registered receive buffers for the dead incarnation must
        all go."""
        if epoch is not None:
            self.epoch = int(epoch)
        self._invalidate_peer(peer)
        for key in [k for k in self._send_seq if k[0] == peer]:
            del self._send_seq[key]
        for key in [k for k in self._recv_seq if k[0] == peer]:
            del self._recv_seq[key]
        self._mail.purge(lambda k: k[0] == peer)
        with self._reg_lock:
            for k in [k for k in self._recv_into_bufs if k[0] == peer]:
                del self._recv_into_bufs[k]
        self._dead.discard(peer)

    # -- lifecycle -------------------------------------------------------------

    def finalize(self) -> None:
        self._closed.set()
        with self._peers_guard:
            socks = list(self._peers.values())
            self._peers.clear()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=1.0)
