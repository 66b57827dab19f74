"""Rendezvous bootstrap: how SocketComm ranks find each other.

SocketComm needs every rank to know every peer's ``(host, port)`` before
the first message, but the whole point of the socket transport is to run
*without* a shared filesystem — so the endpoint exchange is its own tiny
bootstrap protocol with two interchangeable backends:

* **TCP rendezvous server** (``PPYTHON_RDZV_ADDR=host:port``): rank 0
  binds the advertised address and collects one registration record
  ``(pid, epoch, world, endpoint)`` per peer; once all ``np`` ranks are in, it sends
  the complete table back down every connection.  Non-zero ranks
  dial-with-retry (rank 0 may not be up yet), register, and block for
  the table.  This is the shared-filesystem-free path: the only thing a
  multi-node job must agree on up front is one address string.
* **File exchange** (``PPYTHON_RDZV_DIR`` — or the comm dir when one
  exists anyway): each rank atomically publishes ``ep_<pid>`` and polls
  until all ``np`` files are present.  A one-time bootstrap cost on
  clusters that *do* have a shared filesystem but want message traffic
  off it.

Both backends return the same rank-ordered endpoint list, and neither is
on any message path — after bootstrap the rendezvous machinery is gone.

**Epoch fencing (elastic restart).**  Every registration carries the
rank's world generation (``PPYTHON_EPOCH``, bumped by pRUN on each gang
restart).  A server serving generation *g* drops registrations from any
other generation — a ghost of a dead generation can never complete a
fresh table, and a fresh rank can never be served a dead generation's
endpoints.  ``serve_generations`` keeps one listener serving successive
generations for the lifetime of a job (the pRUN launcher's mode), so a
restarted world re-registers fresh endpoints under its bumped epoch
without any port churn.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import time
from pathlib import Path

from .context import StragglerTimeout, recv_timeout, run_epoch

__all__ = [
    "advertised_host",
    "bind_listener",
    "exchange_endpoints",
    "parse_addr",
    "rendezvous_file",
    "rendezvous_tcp",
    "serve_endpoint_table",
    "serve_generations",
]

_LEN = struct.Struct("<I")
_CONNECT_RETRY = 0.05


def parse_addr(addr: str) -> tuple[str, int]:
    """``host:port`` -> ``(host, port)`` (IPv4/hostname form)."""
    host, sep, port = addr.rpartition(":")
    if not sep or not host:
        raise ValueError(f"rendezvous address must be host:port, got {addr!r}")
    return host, int(port)


def advertised_host() -> str:
    """The address this rank tells peers to dial.

    ``PPYTHON_HOST`` wins when set (multi-homed nodes); otherwise the
    primary outbound interface is probed with a connectionless UDP
    socket, falling back to loopback on isolated machines."""
    env = os.environ.get("PPYTHON_HOST")
    if env:
        return env
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))  # no packet is sent
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def bind_listener(host: str = "", port: int = 0,
                  backlog: int = 64) -> socket.socket:
    """Bind-and-listen; binding port 0 picks an ephemeral port, which the
    caller reads back via ``getsockname()`` and advertises through the
    rendezvous."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.listen(backlog)
    return s


def _send_rec(sock: socket.socket, obj) -> None:
    blob = pickle.dumps(obj, protocol=5)
    sock.sendall(_LEN.pack(len(blob)) + blob)


def _recv_rec(sock: socket.socket):
    head = _recv_exact(sock, _LEN.size)
    return pickle.loads(_recv_exact(sock, _LEN.unpack(head)[0]))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if k == 0:
            raise ConnectionError("rendezvous peer closed mid-record")
        got += k
    return bytes(buf)


def _parse_registration(rec) -> tuple[int, int, int | None, tuple]:
    """``(pid, epoch, world, endpoint)`` from a registration record.

    Current ranks register the four-field form — the world size rides
    along so an elastic gang restart (``pRUN(elastic_np=...)``) can
    relaunch at a *different* size and the multi-generation server sizes
    each epoch's table from its own registrants.  The legacy forms are
    still read: ``(pid, endpoint)`` as epoch 0, ``(pid, epoch,
    endpoint)`` without a world (the server falls back to its configured
    size)."""
    if len(rec) == 2:
        peer, ep = rec
        return int(peer), 0, None, tuple(ep)
    if len(rec) == 3:
        peer, epoch, ep = rec
        return int(peer), int(epoch), None, tuple(ep)
    peer, epoch, world, ep = rec
    return int(peer), int(epoch), int(world), tuple(ep)


def serve_endpoint_table(
    srv: socket.socket,
    np_: int,
    deadline: float,
    table: list | None = None,
    epoch: int = 0,
) -> list[tuple[str, int]]:
    """Serve one endpoint exchange on the already-bound listener ``srv``:
    accept one registration record per rank, then send every connection
    the completed table.  Closes ``srv`` when done.

    Registrations from any generation other than ``epoch`` are dropped
    (the connection is closed; a live same-generation rank redials and
    re-registers) — a ghost of a dead generation can neither join nor
    stall the current one.

    Runs inside rank 0 (the ``PPYTHON_RDZV_ADDR`` flow) or on a launcher
    thread (pRUN binds port 0 itself and serves, so the advertised port
    is live from birth — no probe-then-rebind race)."""
    if table is None:
        table = [None] * np_
    srv.settimeout(1.0)
    conns: list[socket.socket] = []
    try:
        while sum(e is not None for e in table) < np_:
            if time.monotonic() > deadline:
                missing = [r for r, e in enumerate(table) if e is None]
                raise StragglerTimeout(
                    f"rendezvous server timed out waiting for ranks "
                    f"{missing} (have {np_ - len(missing)}/{np_})"
                )
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            # accepted sockets are blocking: bound the registration read
            # with a SHORT timeout — a healthy rank registers immediately
            # after connecting, so a silent connection (a rank dying
            # mid-dial, a port scanner hitting the advertised address)
            # must cost seconds, not the whole deadline; a dropped
            # healthy rank redials and re-registers
            conn.settimeout(min(2.0, max(0.5, deadline - time.monotonic())))
            try:
                peer, rec_epoch, world, ep = _parse_registration(
                    _recv_rec(conn))
            except (socket.timeout, ConnectionError, OSError, ValueError,
                    TypeError):
                conn.close()
                continue
            if rec_epoch != epoch:
                conn.close()  # stale-generation ghost (or too-new rank)
                continue
            if (world is not None and world != np_) or not 0 <= peer < np_:
                conn.close()  # registrant from a different-sized world
                continue
            table[peer] = tuple(ep)
            conns.append(conn)
        for conn in conns:
            _send_rec(conn, table)
        return table
    finally:
        for conn in conns:
            conn.close()
        srv.close()


def serve_generations(srv: socket.socket, np_: int, deadline: float) -> None:
    """Serve endpoint exchanges for *successive generations* on one
    listener — the pRUN launcher's mode under ``restarts > 0``.

    Registrations are collected into per-epoch tables; the moment a
    generation's table completes, it is flushed to that generation's
    registrants and cached (a rank whose table read raced a drop redials
    and is answered from the cache).  A ghost registering under a dead
    epoch sits in a forever-incomplete table and is never answered —
    exactly the fence the restart design needs.

    Each generation's table is sized from its registrants' *own* world
    field (``np_`` is only the fallback for legacy records), so an
    elastic restart may relaunch at a different world size
    (``pRUN(elastic_np=...)``) and the same listener serves it;
    registrants of one epoch disagreeing about the world are dropped.
    Returns when ``srv`` is closed; raises ``StragglerTimeout`` if any
    generation is still incomplete at ``deadline``."""
    srv.settimeout(0.5)
    tables: dict[int, list] = {}
    waiting: dict[int, list[socket.socket]] = {}
    done: dict[int, list] = {}
    try:
        while True:
            if time.monotonic() > deadline and tables:
                parts = []
                for e, t in sorted(tables.items()):
                    missing = [r for r, ep in enumerate(t) if ep is None]
                    parts.append(f"epoch {e} missing ranks {missing}")
                raise StragglerTimeout(
                    "rendezvous server timed out with incomplete "
                    "generations: " + "; ".join(parts)
                )
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed: the job is over
            conn.settimeout(min(2.0, max(0.5, deadline - time.monotonic())))
            try:
                peer, epoch, world, ep = _parse_registration(_recv_rec(conn))
            except (socket.timeout, ConnectionError, OSError, ValueError,
                    TypeError):
                conn.close()
                continue
            if epoch in done:
                try:
                    _send_rec(conn, done[epoch])
                except OSError:
                    pass
                conn.close()
                continue
            table = tables.setdefault(epoch, [None] * (world or np_))
            if (world is not None and world != len(table)) \
                    or not 0 <= peer < len(table):
                conn.close()  # world-size disagreement within one epoch
                continue
            table[peer] = tuple(ep)
            waiting.setdefault(epoch, []).append(conn)
            if sum(e is not None for e in table) == len(table):
                for c in waiting.pop(epoch, []):
                    try:
                        _send_rec(c, table)
                    except OSError:
                        pass
                    c.close()
                done[epoch] = tables.pop(epoch)
    finally:
        for conns in waiting.values():
            for c in conns:
                c.close()
        try:
            srv.close()
        except OSError:
            pass


def rendezvous_tcp(
    np_: int,
    pid: int,
    endpoint: tuple[str, int],
    addr: str,
    timeout: float | None = None,
    external_server: bool | None = None,
    epoch: int | None = None,
) -> list[tuple[str, int]]:
    """Exchange endpoints through a TCP rendezvous server at ``addr``;
    returns the rank-ordered ``(host, port)`` table.

    By default rank 0 binds ``addr`` and serves the exchange.  With
    ``external_server`` (or ``PPYTHON_RDZV_EXTERNAL=1``) the server
    already runs elsewhere — e.g. on the pRUN launcher's thread — and
    every rank, including 0, registers as a client.  Registrations carry
    ``epoch`` (default: this process's ``PPYTHON_EPOCH``); the server
    drops other-generation registrations, and a dropped client redials —
    so a ghost can neither join nor be served the current table."""
    limit = recv_timeout() if timeout is None else timeout
    deadline = time.monotonic() + limit
    host, port = parse_addr(addr)
    if epoch is None:
        epoch = run_epoch()
    if external_server is None:
        external_server = bool(os.environ.get("PPYTHON_RDZV_EXTERNAL"))
    if pid == 0 and not external_server:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind((host if host not in ("localhost",) else "", port))
        except OSError:
            # the advertised host may be another interface's name on this
            # node; fall back to all interfaces on the agreed port
            srv.bind(("", port))
        srv.listen(np_)
        table: list = [None] * np_
        table[0] = tuple(endpoint)
        return serve_endpoint_table(srv, np_, deadline, table, epoch=epoch)
    # client: dial + register with retry (the server may still be
    # starting, and it drops connections whose registration read timed
    # out or whose epoch mismatched — redialing re-registers)
    while True:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.settimeout(max(0.5, deadline - time.monotonic()))
            sock.connect((host, port))
            _send_rec(sock, (pid, epoch, np_, tuple(endpoint)))
            sock.settimeout(max(0.5, deadline - time.monotonic()))
            table = _recv_rec(sock)
            break
        except (OSError, ConnectionError):
            if time.monotonic() > deadline:
                raise StragglerTimeout(
                    f"rank {pid} could not complete the rendezvous with "
                    f"{addr} within {limit:.0f}s (epoch {epoch})"
                ) from None
            time.sleep(_CONNECT_RETRY)
        finally:
            sock.close()
    return [tuple(e) for e in table]


def rendezvous_file(
    np_: int,
    pid: int,
    endpoint: tuple[str, int],
    rdzv_dir: str | os.PathLike,
    timeout: float | None = None,
    epoch: int | None = None,
) -> list[tuple[str, int]]:
    """One-time endpoint exchange through a shared directory: publish
    ``ep_<pid>`` atomically, poll until all ``np`` are present.

    After reading the table each rank drops a ``rdzv_done_<pid>`` marker;
    rank 0 reclaims every exchange file once all markers exist (bounded
    best-effort), so reusing the directory for a later run can never
    serve that run a stale endpoint table.  Under elastic restart the
    filenames carry an ``E<epoch>_`` token (epoch > 0 only, so epoch-0
    layouts are unchanged): a relaunched generation exchanges through
    fresh names and can never read a dead generation's endpoints, even
    when rank 0 died before reclaiming them."""
    limit = recv_timeout() if timeout is None else timeout
    if epoch is None:
        epoch = run_epoch()
    etok = f"E{epoch}_" if epoch > 0 else ""
    d = Path(rdzv_dir)
    d.mkdir(parents=True, exist_ok=True)
    mine = d / f"{etok}ep_{pid}"
    tmp = mine.with_suffix(f".tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        pickle.dump(tuple(endpoint), f, protocol=5)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, mine)
    deadline = time.monotonic() + limit
    pause = 0.001
    table = None
    while table is None:
        paths = [d / f"{etok}ep_{r}" for r in range(np_)]
        if all(p.exists() for p in paths):
            table = []
            for p in paths:
                with open(p, "rb") as f:
                    table.append(tuple(pickle.load(f)))
            break
        if time.monotonic() > deadline:
            missing = [r for r in range(np_)
                       if not (d / f"{etok}ep_{r}").exists()]
            raise StragglerTimeout(
                f"rank {pid} timed out in file rendezvous {d}; "
                f"missing ranks: {missing}"
            )
        time.sleep(pause)
        pause = min(pause * 2, 0.05)
    # a rank marks done only after its table is in hand, and rank 0
    # deletes only after every marker exists — no reader can lose a file
    # it still needs
    (d / f"{etok}rdzv_done_{pid}").touch()
    if pid == 0:
        reclaim_by = min(deadline, time.monotonic() + 10.0)
        markers = [d / f"{etok}rdzv_done_{r}" for r in range(np_)]
        while not all(m.exists() for m in markers):
            if time.monotonic() > reclaim_by:
                return table  # a peer died post-exchange: leave evidence
            time.sleep(0.01)
        for p in markers + [d / f"{etok}ep_{r}" for r in range(np_)]:
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
    return table


def exchange_endpoints(
    np_: int,
    pid: int,
    endpoint: tuple[str, int],
    *,
    addr: str | None = None,
    rdzv_dir: str | os.PathLike | None = None,
    timeout: float | None = None,
    epoch: int | None = None,
) -> list[tuple[str, int]]:
    """Backend dispatch: explicit args first, then ``PPYTHON_RDZV_ADDR``,
    then ``PPYTHON_RDZV_DIR``/``PPYTHON_COMM_DIR`` as the file fallback."""
    addr = addr or os.environ.get("PPYTHON_RDZV_ADDR")
    if addr:
        return rendezvous_tcp(np_, pid, endpoint, addr, timeout=timeout,
                              epoch=epoch)
    rdzv_dir = (rdzv_dir or os.environ.get("PPYTHON_RDZV_DIR")
                or os.environ.get("PPYTHON_COMM_DIR"))
    if rdzv_dir:
        return rendezvous_file(np_, pid, endpoint, rdzv_dir, timeout=timeout,
                               epoch=epoch)
    raise ValueError(
        "socket transport needs a rendezvous: set PPYTHON_RDZV_ADDR "
        "(host:port TCP bootstrap, no shared filesystem needed) or "
        "PPYTHON_RDZV_DIR (one-time file exchange)"
    )
