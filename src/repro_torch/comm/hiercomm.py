"""HierComm — topology-aware composite transport: shm within a node,
sockets across nodes.

A multi-node job pays TCP latency only where the wire is unavoidable.
``HierComm`` discovers topology at bootstrap: each rank publishes a host
fingerprint through the rendezvous alongside its TCP endpoint, and every
peer pair is then routed over the best fabric — same host → ``ShmComm``
ring arenas, different host → ``SocketComm`` connections.  The
``PPYTHON_NODE_ID`` environment variable overrides the fingerprint, so
CI and single-machine runs can partition ranks into *virtual nodes* and
exercise both paths deterministically.

Routing is static per pair: a given (src, dst) always uses one fabric,
so each inner transport's per-(source, tag) FIFO sequence streams stay
consistent and the full messaging contract (``send``/``isend``/
``irecv``/``irecv_into``/``wait_all``/``probe``, chunking) is inherited
by delegation.  Self-sends take the shared-memory side (an in-memory
path there).  The inner ``ShmComm`` only creates inbound arenas for
same-node senders — no ring is ever allocated for a pair that talks
over TCP — and a send routed to the wrong fabric fails loudly at arena
attach instead of silently crossing fabrics.

The collectives layer reads the topology this context exposes
(``node_ids``, ``node_peers``) and switches to two-level algorithms —
intra-node over shared memory, node leaders over TCP — whenever a
group spans nodes (see ``collectives.py``).

Per-fabric send counters (``fabric_sends``) make the routing property
observable: with two virtual nodes, every intra-node message must be
counted against ``shm`` and every inter-node message against ``tcp``.
"""

from __future__ import annotations

import os
import socket as _socket
from typing import Any

import numpy as np

from .context import CommContext, Request, run_epoch
from .liveness import SNAPSHOT_LIMIT
from .rendezvous import advertised_host, bind_listener, exchange_endpoints
from .shmcomm import ShmComm
from .socketcomm import SocketComm

__all__ = ["HierComm", "node_label"]


def node_label(override: str | None = None) -> str:
    """The node-membership fingerprint this rank publishes.

    ``PPYTHON_NODE_ID`` (or the explicit ``override``) wins — that is
    the virtual-node switch; otherwise the hostname identifies the
    physical node.  The two namespaces are kept disjoint so a virtual
    partition can never collide with a real hostname."""
    vnode = override if override is not None else os.environ.get(
        "PPYTHON_NODE_ID")
    if vnode is not None and vnode != "":
        return f"vnode:{vnode}"
    return f"host:{_socket.gethostname()}"


class HierComm(CommContext):
    """Composite rank endpoint: ShmComm arenas intra-node, SocketComm
    TCP inter-node, one fabric per peer pair chosen by node membership.

    ``node_ids`` is the rank-ordered tuple of dense node indices every
    rank agrees on (``bootstrap`` derives it from the rendezvous
    exchange); ``endpoints``/``listener`` wire the inner SocketComm and
    ``shm_dir``/``nonce`` the inner ShmComm exactly as for the plain
    transports.
    """

    # the bulk legs of a two-level collective ride the shm fabric, whose
    # memory bandwidth keeps the eager tree competitive far past the
    # wire-transport switch point; the TCP legs are already down to one
    # payload per node, so the shm threshold governs
    coll_eager_default = ShmComm.coll_eager_default

    def __init__(self, np_: int, pid: int, endpoints, listener, node_ids,
                 shm_dir: str | os.PathLike, arena_bytes: int | None = None,
                 nonce: str | None = None, epoch: int | None = None):
        if not (0 <= pid < np_):
            raise ValueError(f"pid {pid} out of range for np={np_}")
        if len(node_ids) != np_:
            raise ValueError(
                f"node_ids covers {len(node_ids)} ranks, world is {np_}"
            )
        self.np_ = np_
        self.pid = pid
        self.epoch = run_epoch() if epoch is None else int(epoch)
        self.node_ids = tuple(int(n) for n in node_ids)
        self.node_id = self.node_ids[pid]
        self.node_peers = tuple(
            r for r in range(np_) if self.node_ids[r] == self.node_id
        )
        # routing property instrumentation: messages posted per fabric
        self.fabric_sends = {"shm": 0, "tcp": 0}
        same_node_senders = [r for r in self.node_peers if r != pid]
        try:
            self._shm = ShmComm(np_, pid, shm_dir, arena_bytes=arena_bytes,
                                nonce=nonce, senders=same_node_senders,
                                epoch=self.epoch)
        except BaseException:
            listener.close()
            raise
        try:
            self._sock = SocketComm(np_, pid, endpoints, listener,
                                    epoch=self.epoch)
        except BaseException:
            self._shm.finalize()
            raise

    # -- bootstrap -------------------------------------------------------------

    @classmethod
    def bootstrap(cls, np_: int, pid: int, *, rdzv_addr: str | None = None,
                  rdzv_dir=None, host: str | None = None,
                  timeout: float | None = None,
                  shm_dir: str | os.PathLike | None = None,
                  nonce: str | None = None) -> "HierComm":
        """Bind a listener, publish ``(host, port, node fingerprint)``
        through the endpoint rendezvous, and build the composite context
        from the returned table.

        The rendezvous carries arbitrary pickled tuples, so the richer
        record rides the existing TCP and file protocols unchanged.
        Node fingerprints are mapped to dense ids in rank order —
        deterministic, so every rank derives the identical topology.
        """
        host = host or advertised_host()
        listener = bind_listener("")
        port = listener.getsockname()[1]
        try:
            table = exchange_endpoints(
                np_, pid, (host, port, node_label()),
                addr=rdzv_addr, rdzv_dir=rdzv_dir, timeout=timeout,
            )
        except BaseException:
            listener.close()
            raise
        endpoints = [(h, p) for h, p, _label in table]
        labels = [label for _h, _p, label in table]
        dense: dict[str, int] = {}
        node_ids = tuple(dense.setdefault(lbl, len(dense)) for lbl in labels)
        if shm_dir is None:
            shm_dir = os.environ.get("PPYTHON_SHM_DIR")
            if not shm_dir:
                comm_dir = os.environ.get("PPYTHON_COMM_DIR")
                if not comm_dir:
                    listener.close()
                    raise ValueError(
                        "PPYTHON_TRANSPORT=hier needs PPYTHON_SHM_DIR "
                        "(or PPYTHON_COMM_DIR to derive it from) for the "
                        "intra-node arenas"
                    )
                shm_dir = os.path.join(comm_dir, "shm")
        return cls(np_, pid, endpoints, listener, node_ids, shm_dir,
                   nonce=nonce)

    # -- routing ---------------------------------------------------------------

    def fabric_of(self, peer: int) -> str:
        """``"shm"`` or ``"tcp"`` — which fabric reaches ``peer``."""
        if not (0 <= peer < self.np_):
            raise ValueError(f"peer {peer} out of range for np={self.np_}")
        return "shm" if self.node_ids[peer] == self.node_id else "tcp"

    def _fab(self, peer: int):
        if not (0 <= peer < self.np_):
            raise ValueError(f"peer {peer} out of range for np={self.np_}")
        if self.node_ids[peer] == self.node_id:
            return self._shm, "shm"
        return self._sock, "tcp"

    # -- messaging contract: pure delegation per peer --------------------------

    def send(self, dest: int, tag: Any, obj: Any) -> None:
        fab, name = self._fab(dest)
        self.fabric_sends[name] += 1
        fab.send(dest, tag, obj)

    def isend(self, dest: int, tag: Any, obj: Any) -> Request:
        fab, name = self._fab(dest)
        self.fabric_sends[name] += 1
        return fab.isend(dest, tag, obj)

    def recv(self, source: int, tag: Any,
             timeout: float | None = None) -> Any:
        return self._fab(source)[0].recv(source, tag, timeout=timeout)

    def irecv(self, source: int, tag: Any) -> Request:
        return self._fab(source)[0].irecv(source, tag)

    def irecv_into(self, source: int, tag: Any,
                   buffer: np.ndarray) -> Request:
        return self._fab(source)[0].irecv_into(source, tag, buffer)

    def probe(self, source: int, tag: Any) -> bool:
        return self._fab(source)[0].probe(source, tag)

    # -- elastic restart -------------------------------------------------------

    def dead_ranks(self) -> list[int]:
        """Union of both fabrics' dead-peer evidence, filtered to the
        peers each fabric actually carries (liveness contract)."""
        dead = set()
        for peer in self._shm.dead_ranks():
            if self.fabric_of(peer) == "shm":
                dead.add(peer)
        for peer in self._sock.dead_ranks():
            if self.fabric_of(peer) == "tcp":
                dead.add(peer)
        return sorted(dead)

    def pending_snapshot(self, limit: int = SNAPSHOT_LIMIT) -> list:
        merged = (list(self._shm.pending_snapshot(limit))
                  + list(self._sock.pending_snapshot(limit)))
        return sorted(merged, key=str)[:limit]

    def epoch_reset(self, peer: int, epoch: int | None = None) -> None:
        """Delegate the epoch-boundary stream reset to the fabric that
        owns the (self, peer) pair."""
        if epoch is not None:
            self.epoch = int(epoch)
        self._fab(peer)[0].epoch_reset(peer, epoch=epoch)

    def finalize(self) -> None:
        try:
            self._sock.finalize()
        finally:
            self._shm.finalize()
