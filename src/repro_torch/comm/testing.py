"""SPMD harness helpers for tests and benchmarks: the transport matrix.

``run_transport_spmd(fn, np_, transport)`` mirrors
``threadcomm.run_spmd`` but hosts each rank's context on a thread over
any of the five transports — ``thread`` (in-memory mailboxes), ``file``
(the paper's shared-directory FileMPI), ``socket`` (the TCP peer mesh),
``shm`` (mmap'd ring arenas), ``hier`` (the composite fabric: shm
within a virtual node, TCP across them) — so one parametrized test
exercises every algorithm on every fabric without process-launch
overhead.  Kept in the package (not ``tests/``) so the test suite and
the collective/redistribution/pingpong benchmarks import one copy.
"""

from __future__ import annotations

import itertools
import os
import tempfile
import threading
from typing import Any, Callable

from .context import CommContext, set_context
from .filempi import FileMPI
from .hiercomm import HierComm
from .rendezvous import bind_listener
from .shmcomm import ShmComm
from .socketcomm import SocketComm
from .threadcomm import run_spmd

__all__ = [
    "TRANSPORTS",
    "run_filempi_spmd",
    "run_hier_spmd",
    "run_shm_spmd",
    "run_socket_spmd",
    "run_transport_spmd",
    "shm_base_dir",
    "virtual_node_ids",
]

# the full matrix every algorithm test should pass on
TRANSPORTS = ("thread", "file", "socket", "shm", "hier")

_shm_run_counter = itertools.count()


def shm_base_dir() -> str:
    """Where throwaway shm-arena directories go: ``/dev/shm`` when the
    node has it (arena pages then never touch a writeback path), else
    the regular temp dir — MAP_SHARED on any file is still coherent."""
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def _run_ctx_spmd(
    make_ctx: Callable[[int], CommContext],
    fn: Callable[..., Any],
    np_: int,
    args: tuple,
    timeout: float,
    label: str,
) -> list[Any]:
    """Host ``np_`` contexts on threads, run ``fn(*args)`` per rank, and
    return rank-ordered results; the first rank exception is re-raised.
    Contexts are finalized even when a rank fails, so sockets/threads
    never leak across tests."""
    results: list[Any] = [None] * np_
    errors: list[BaseException | None] = [None] * np_

    def body(pid: int) -> None:
        try:
            ctx = make_ctx(pid)
        except BaseException as e:  # noqa: BLE001 - surfaced to caller
            errors[pid] = e
            return
        set_context(ctx)
        try:
            results[pid] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - surfaced to caller
            errors[pid] = e
        finally:
            set_context(None)
            ctx.finalize()

    threads = [threading.Thread(target=body, args=(pid,)) for pid in range(np_)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    for t in threads:
        if t.is_alive():
            raise RuntimeError(f"{label} SPMD body did not finish in time")
    for e in errors:
        if e is not None:
            raise e
    return results


def run_filempi_spmd(
    fn: Callable[..., Any],
    np_: int,
    comm_dir,
    args: tuple = (),
    timeout: float = 120.0,
) -> list[Any]:
    """Run ``fn(*args)`` as an SPMD body on ``np_`` FileMPI thread-ranks.

    Heartbeats are off (single process — liveness is the thread's)."""
    return _run_ctx_spmd(
        lambda pid: FileMPI(np_=np_, pid=pid, comm_dir=comm_dir,
                            heartbeat=False),
        fn, np_, args, timeout, "FileMPI",
    )


def run_socket_spmd(
    fn: Callable[..., Any],
    np_: int,
    args: tuple = (),
    timeout: float = 120.0,
) -> list[Any]:
    """Run ``fn(*args)`` as an SPMD body on ``np_`` SocketComm
    thread-ranks over loopback TCP.

    Every rank's listener is bound up front and the endpoint table
    shared directly (the in-process analogue of the rendezvous — the
    rendezvous protocols themselves are covered by dedicated tests), so
    the body starts with all peers reachable, exactly as after a real
    bootstrap."""
    listeners = [bind_listener("127.0.0.1") for _ in range(np_)]
    endpoints = [("127.0.0.1", s.getsockname()[1]) for s in listeners]
    return _run_ctx_spmd(
        lambda pid: SocketComm(np_, pid, endpoints, listeners[pid]),
        fn, np_, args, timeout, "SocketComm",
    )


def run_shm_spmd(
    fn: Callable[..., Any],
    np_: int,
    args: tuple = (),
    timeout: float = 120.0,
    shm_dir=None,
) -> list[Any]:
    """Run ``fn(*args)`` as an SPMD body on ``np_`` ShmComm thread-ranks
    over a throwaway arena directory (under ``/dev/shm`` when present).

    Each run gets a fresh nonce, so a reused directory can never serve a
    previous run's arenas; rank contexts unlink their inbound arenas at
    finalize and the directory itself is reclaimed when throwaway."""
    nonce = f"spmd-{os.getpid()}-{next(_shm_run_counter)}"
    if shm_dir is not None:
        return _run_ctx_spmd(
            lambda pid: ShmComm(np_, pid, shm_dir, nonce=nonce),
            fn, np_, args, timeout, "ShmComm",
        )
    with tempfile.TemporaryDirectory(
            prefix="ppython_shm_", dir=shm_base_dir()) as d:
        return _run_ctx_spmd(
            lambda pid: ShmComm(np_, pid, d, nonce=nonce),
            fn, np_, args, timeout, "ShmComm",
        )


def virtual_node_ids(np_: int, nodes: int) -> tuple[int, ...]:
    """Contiguous-block virtual-node assignment for ``np_`` ranks over
    ``nodes`` nodes (clamped to ``np_`` so every node is populated) —
    the same partition ``pRUN(transport="hier", nodes=N)`` exports."""
    nodes = max(1, min(int(nodes), np_))
    return tuple(r * nodes // np_ for r in range(np_))


def run_hier_spmd(
    fn: Callable[..., Any],
    np_: int,
    args: tuple = (),
    timeout: float = 120.0,
    nodes: int = 2,
    node_ids=None,
) -> list[Any]:
    """Run ``fn(*args)`` as an SPMD body on ``np_`` HierComm thread-ranks:
    ranks are split into ``nodes`` contiguous *virtual nodes* (default
    2), so intra-node traffic moves through throwaway shm arenas and
    inter-node traffic over loopback TCP — both fabrics of the composite
    transport exercised on one machine.  Pass ``node_ids`` for an
    explicit rank → node table."""
    if node_ids is None:
        node_ids = virtual_node_ids(np_, nodes)
    if len(node_ids) != np_:
        raise ValueError(f"node_ids covers {len(node_ids)} ranks, "
                         f"world is {np_}")
    listeners = [bind_listener("127.0.0.1") for _ in range(np_)]
    endpoints = [("127.0.0.1", s.getsockname()[1]) for s in listeners]
    nonce = f"spmd-{os.getpid()}-{next(_shm_run_counter)}"
    with tempfile.TemporaryDirectory(
            prefix="ppython_hier_", dir=shm_base_dir()) as d:
        return _run_ctx_spmd(
            lambda pid: HierComm(np_, pid, endpoints, listeners[pid],
                                 node_ids, d, nonce=nonce),
            fn, np_, args, timeout, "HierComm",
        )


def run_transport_spmd(
    fn: Callable[..., Any],
    np_: int,
    transport: str,
    comm_dir=None,
    args: tuple = (),
    timeout: float = 120.0,
) -> list[Any]:
    """One SPMD entry point across the transport matrix.

    ``transport`` is ``thread``/``file``/``socket``/``shm``/``hier``
    (``filempi`` accepted as an alias for ``file``); ``comm_dir`` is only
    consulted by the file transport and defaults to a throwaway temp
    directory (shm/hier arenas live in their own throwaway directory
    under ``/dev/shm``; ``hier`` splits ranks into 2 virtual nodes)."""
    if transport == "thread":
        return run_spmd(fn, np_, args=args, timeout=timeout)
    if transport in ("file", "filempi"):
        if comm_dir is not None:
            return run_filempi_spmd(fn, np_, comm_dir, args=args,
                                    timeout=timeout)
        with tempfile.TemporaryDirectory(prefix="ppython_test_") as d:
            return run_filempi_spmd(fn, np_, d, args=args, timeout=timeout)
    if transport == "socket":
        return run_socket_spmd(fn, np_, args=args, timeout=timeout)
    if transport == "shm":
        return run_shm_spmd(fn, np_, args=args, timeout=timeout)
    if transport == "hier":
        return run_hier_spmd(fn, np_, args=args, timeout=timeout)
    raise ValueError(
        f"unknown transport {transport!r} (expected one of {TRANSPORTS})"
    )
