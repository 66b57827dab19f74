"""Scalable collective algorithms over any PythonMPI transport.

The paper's derived collectives (``context.py``) were flat O(P) patterns
rooted at one rank: a serialized linear ``bcast`` fan-out, a central
gather-and-release ``barrier``, gather-to-0-plus-bcast ``allgather``.
Those are fine at np=4 and a root bottleneck at np=64 — the HPC Challenge
results (and the pMatlab lineage this reproduces) hinge on the *library*
picking communication algorithms, not the user.  This module is that
layer:

=================  ========================================================
collective         algorithms (``algo=`` accepts any name; ``None`` = auto)
=================  ========================================================
``bcast``          ``tree`` (binomial), ``ring`` (chunked/pipelined, long
                   ndarrays), ``onefile`` (FileMPI single-payload-file),
                   ``linear`` (the seed baseline, kept for benchmarking)
``reduce``         ``tree`` (binomial)
``gather``         ``flat`` (one isend per child, root completes in
                   *arrival* order), ``tree`` (binomial, latency-bound
                   regimes)
``allgather``      ``rd`` (recursive doubling, power-of-two groups),
                   ``ring``, ``gatherbcast`` (seed baseline)
``allreduce``      ``rd`` (recursive doubling with non-power-of-two
                   folding), ``ring`` (reduce-scatter + allgather, long
                   ndarrays), ``gather`` (seed allgather-then-reduce
                   baseline)
``reduce_scatter`` ``ring``
``alltoallv``      ``pairwise`` (rotated pairwise exchange)
``barrier``        ``dissem`` (dissemination), ``central`` (seed baseline)
=================  ========================================================

Algorithm selection is message-size based: payloads at or below
``PPYTHON_COLL_EAGER_BYTES`` (default 64 KiB) take the eager
latency-optimal algorithm; larger ndarrays take the chunked/pipelined
bandwidth-optimal one.  Selection that depends on payload size only uses
sizes every participant can see (the root's for ``bcast`` — it ships a
tiny tree header before a ring transfer — and the local value for
``allreduce``, whose operands must be congruent across ranks anyway).

``Group`` scopes every collective to an ordered subset of world ranks —
any ``Dmap.proclist``, including non-contiguous, permuted, and
non-zero-rooted lists — with tags derived from a per-(group, op) SPMD
counter, so concurrent collectives on disjoint or identical groups can
never cross-match message streams.  ``Group.split(color, key)`` derives
sub-communicators MPI_Comm_split-style.

Topology awareness: when the context exposes ``node_ids`` (HierComm —
shm within a node, TCP across nodes) and a group spans more than one
node with at least one non-singleton node, auto-mode ``allreduce``,
``bcast``, ``barrier``, ``allgather``, and ``reduce_scatter`` switch to
two-level algorithms — the intra-node leg runs over shared memory and
only node *leaders* (the first group-order member of each node) touch
the wire.  Allreduce, e.g., becomes intra-node reduce → inter-node
allreduce among leaders → intra-node bcast: the TCP leg moves one
payload per node instead of one per rank.  An explicit ``algo=`` always
bypasses the two-level path, and the sub-phases reuse the flat
machinery below (so persistent staging and ``irecv_into`` still apply
within each level).

Buffer semantics: on by-reference transports (ThreadComm) every hop
copies *mutable* ndarray payloads before posting (``_pin``), so a
collective's inputs may be mutated the moment it returns and its outputs
are private to each rank — MPI's contract.  Read-only arrays travel by
reference; ``bcast`` exploits this with a frozen-buffer fast path (one
pinning copy at the root, zero-copy fan-out — the in-process analogue of
FileMPI's one-payload-file broadcast), so non-root ranks receive
read-only views and must ``.copy()`` before mutating.  Serializing
transports (FileMPI) pin by construction and pay no extra copy.

The port's own copy of ``repro.comm.collectives`` (NumPy only), for the checkpoint's
``Dmat`` paths; it differs from the original in its docstrings alone.
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import Any, Callable, Sequence

import numpy as np

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .context import CommContext, _freeze, ctx_counter

__all__ = [
    "Group",
    "group_of",
    "world_group",
    "eager_bytes",
    "payload_nbytes",
    "select_bcast",
    "select_allreduce",
    "select_allgather",
    "select_gather",
    "coll_stats",
    "reset_coll_stats",
    "DEFAULT_EAGER_BYTES",
]

DEFAULT_EAGER_BYTES = 64 * 1024

# chunked-ring transfers pipeline at this many pieces at most; enough to
# hide the (P-2)-hop ring fill at any realistic payload size
_MAX_RING_CHUNKS = 32


def eager_bytes(default: int | None = None) -> int:
    """Eager/rendezvous switch point (``PPYTHON_COLL_EAGER_BYTES``).

    The env var always wins; otherwise ``default`` lets a transport ship
    its own tuning (ShmComm's intra-node memory bandwidth keeps the
    eager tree competitive to 256 KiB) without touching the global."""
    raw = os.environ.get("PPYTHON_COLL_EAGER_BYTES", "")
    if raw:
        return int(raw)
    return DEFAULT_EAGER_BYTES if default is None else default


def payload_nbytes(obj: Any) -> int:
    """Bytes that matter for algorithm selection (0 for non-arrays:
    objects are pickled small things and always go eager)."""
    return obj.nbytes if isinstance(obj, np.ndarray) else 0


# ---------------------------------------------------------------------------
# Pure selection functions (unit-testable; the --smoke bench asserts them)
# ---------------------------------------------------------------------------


def select_bcast(nbytes: int, size: int, onefile: bool = False,
                 eager: int | None = None) -> str:
    """Bcast policy for *serializing* transports.  FileMPI overrides it
    with the one-file path, and on by-reference transports ``Group.bcast``
    prefers the frozen-buffer tree (one pinned copy, zero-copy fan-out)
    for ndarrays at every size — SocketComm is the transport that follows
    this table as-is: eager tree for small payloads, chunked ring for
    long ndarrays.  ``eager`` is the transport-tuned switch point
    (``Group`` passes its context's; the env var still wins inside
    :func:`eager_bytes`)."""
    if onefile:
        # one payload file + N in-place readers beats any message tree on a
        # shared filesystem (MatlabMPI's trick)
        return "onefile"
    if size <= 2 or nbytes <= eager_bytes(eager):
        return "tree"
    return "ring"


def select_allreduce(nbytes: int, size: int, eager: int | None = None) -> str:
    # the ring needs nbytes to be a real ndarray payload worth chunking
    if size <= 2 or nbytes <= eager_bytes(eager):
        return "rd"
    return "ring"


def select_allgather(size: int) -> str:
    # per-rank contributions may differ in size, so selection must not
    # depend on the local payload; power-of-two groups take log-step
    # recursive doubling, the rest the size-agnostic ring
    return "rd" if size & (size - 1) == 0 else "ring"


def select_gather(size: int) -> str:
    # flat arrival-order completion moves each payload once (bandwidth
    # optimal); the binomial tree only wins on latency at larger fan-in
    return "tree" if size >= 16 else "flat"


# ---------------------------------------------------------------------------
# Observability: hop-level counters (the redist exec_stats idea applied
# to collectives) — tests assert the ring paths are allocation-free
# ---------------------------------------------------------------------------


# Process-wide counters over collective data movement, living in the
# obs.metrics registry under the "coll." prefix:
#
#   ring_hops_into    ring hops received into persistent staging or
#                     final storage via ``irecv_into`` (no fresh
#                     receive buffer);
#   ring_hops_alloc   ring hops that still allocate a fresh receive
#                     buffer (the unstaged fallback paths);
#   staging_allocs    persistent per-group staging buffers created
#                     (steady state: zero — buffers are reused).
_COLL_KEYS = ("ring_hops_into", "ring_hops_alloc", "staging_allocs")
_COLL = {k: _metrics.counter("coll." + k) for k in _COLL_KEYS}


def coll_stats() -> dict[str, int]:
    """Counters of collective hop mechanics since the last reset — a
    view over the ``coll.*`` counters in ``repro.obs.metrics``."""
    return {k: c.value for k, c in _COLL.items()}


def reset_coll_stats() -> None:
    """Thin alias of ``repro.obs.metrics.reset()``: one reset zeroes
    every registry metric (redist, collectives, serve)."""
    _metrics.reset()


def _traced_coll(op: str):
    """Span each collective entry point (group size + op attached);
    free when tracing is disabled — one module-attribute check."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            if not _trace.enabled:
                return fn(self, *args, **kwargs)
            with _trace.span("coll." + op, size=self.size, rank=self.rank):
                return fn(self, *args, **kwargs)

        return wrapper

    return deco


def _traced_hier(op: str):
    """Span the two-level (intra-node + leader) composite path.  The
    per-leg work shows up as the nested ``coll.*`` spans of the intra
    and leader sub-groups; this outer span marks the composite and its
    topology (node count, local width)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args):
            if not _trace.enabled:
                return fn(self, *args)
            parts = args[-1]
            with _trace.span("coll.two_level", op=op,
                             intra_width=len(parts[0]),
                             nodes=len(parts[1])):
                return fn(self, *args)

        return wrapper

    return deco


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _group_token(ranks: tuple[int, ...]) -> str:
    """Short stable token naming a rank set (tag component)."""
    if ranks == tuple(range(len(ranks))):
        return f"w{len(ranks)}"
    return hashlib.sha1(repr(ranks).encode()).hexdigest()[:10]


def _is_frozen(arr: np.ndarray) -> bool:
    """Safely immutable: read-only AND owns its buffer.  A read-only
    *view* of a writeable base can still be mutated through the base, so
    only owning arrays qualify for by-reference travel."""
    return (not arr.flags.writeable) and arr.base is None and arr.flags.owndata


def _frozen_owned(arr: np.ndarray) -> np.ndarray:
    """``arr`` if already safely immutable, else a read-only owning copy."""
    if not _is_frozen(arr):
        arr = arr.copy()
        arr.setflags(write=False)
    return arr


def _pin(ctx: CommContext, obj: Any) -> Any:
    """Copy array payloads on by-reference transports so the sender may
    mutate its buffer immediately and no two ranks ever alias one
    *mutable* array.  Safely immutable arrays (see ``_is_frozen``) travel
    by reference — the zero-copy fast path frozen-buffer broadcast rides
    on."""
    if not getattr(ctx, "payload_by_reference", False):
        return obj
    if isinstance(obj, np.ndarray):
        return obj if _is_frozen(obj) else obj.copy()
    if isinstance(obj, tuple):
        pinned = [_pin(ctx, o) for o in obj]
        # namedtuples reconstruct via _make; plain tuples (and subclasses
        # without it) via tuple() — type(obj)(generator) would TypeError
        # on namedtuple's positional constructor
        return obj._make(pinned) if hasattr(obj, "_make") else tuple(pinned)
    if isinstance(obj, list):
        return [_pin(ctx, o) for o in obj]
    if isinstance(obj, dict):
        return {k: _pin(ctx, v) for k, v in obj.items()}
    return obj


def _combine(op: Callable, a: Any, b: Any) -> Any:
    """None-aware reduction step (ranks with empty local parts contribute
    ``None``, e.g. zero-size Dmat reductions)."""
    if a is None:
        return b
    if b is None:
        return a
    return op(a, b)


# sentinel for Group._topo: "not derived yet" (None means "flat")
_TOPO_UNSET = object()


class Group:
    """Ordered subset of a context's ranks with its own collective scope.

    ``ranks`` may be any duplicate-free world-pid sequence — the order
    defines group ranks (``self.rank``), so a permuted ``Dmap.proclist``
    keeps its meaning.  Only members may invoke collectives.  Tags derive
    from a per-(group, op) counter that every member advances in the same
    SPMD order, so interleaved collectives — even on the *same* group —
    can never cross-match, and two groups never share a tag space.
    """

    def __init__(self, ctx: CommContext, ranks: Sequence[int]):
        ranks = tuple(int(r) for r in ranks)
        if not ranks:
            raise ValueError("a Group needs at least one rank")
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"group ranks contain duplicates: {ranks}")
        for r in ranks:
            if not (0 <= r < ctx.np_):
                raise ValueError(f"rank {r} out of range for np={ctx.np_}")
        self.ctx = ctx
        self.ranks = ranks
        self.size = len(ranks)
        self.rank = ranks.index(ctx.pid) if ctx.pid in ranks else None
        self.key = _group_token(ranks)
        # persistent per-group staging (ring work/hop buffers), grow-only
        # and keyed by role + dtype: groups are memoized per context
        # (``group_of``), so steady-state iterative collectives reuse
        # these across calls and allocate nothing per hop
        self._staging: dict[tuple, np.ndarray] = {}
        self._topo: Any = _TOPO_UNSET

    def __repr__(self) -> str:
        return f"Group(ranks={list(self.ranks)}, rank={self.rank})"

    # -- plumbing ----------------------------------------------------------

    def _require_member(self) -> int:
        if self.rank is None:
            raise ValueError(
                f"rank {self.ctx.pid} is not a member of group {self.ranks}"
            )
        return self.rank

    def _root_rank(self, root: int | None) -> int:
        """Group rank of a world-pid root (default: first group member)."""
        root = self.ranks[0] if root is None else int(root)
        try:
            return self.ranks.index(root)
        except ValueError:
            raise ValueError(f"root {root} is not in group {self.ranks}") from None

    def _base_tag(self, op: str, tag: Any):
        if tag is not None:
            return ("__coll", self.key, op, "u", _freeze(tag))
        return ("__coll", self.key, op,
                ctx_counter(self.ctx, ("__coll", self.key, op)))

    def _send(self, dst: int, tag: Any, obj: Any) -> None:
        self.ctx.isend(self.ranks[dst], tag, _pin(self.ctx, obj))

    def _freeze_hop(self, obj: Any) -> Any:
        """Freeze a *received* block in place before forwarding it on, so
        ring laps circulate references instead of per-hop copies.  Safe
        because a received block on a by-reference transport is already
        this rank's private owned copy (the sender pinned it)."""
        if (getattr(self.ctx, "payload_by_reference", False)
                and isinstance(obj, np.ndarray)
                and obj.base is None and obj.flags.owndata):
            obj.setflags(write=False)
        return obj

    def _recv(self, src: int, tag: Any) -> Any:
        return self.ctx.recv(self.ranks[src], tag)

    def _irecv(self, src: int, tag: Any):
        return self.ctx.irecv(self.ranks[src], tag)

    def _recv_into(self, src: int, tag: Any, buffer: np.ndarray) -> None:
        """Blocking receive landing in ``buffer`` (a ring-hop primitive:
        serializing transports decode payload bytes straight into it)."""
        self.ctx.irecv_into(self.ranks[src], tag, buffer).wait()
        _COLL["ring_hops_into"].inc()

    def _eager(self) -> int:
        """This group's eager/rendezvous switch point: the env var if
        set, else the transport's tuned default (e.g. ShmComm's 256 KiB),
        else the global default."""
        return eager_bytes(getattr(self.ctx, "coll_eager_default", None))

    def _staging_buf(self, role: str, nelems: int, dtype) -> np.ndarray:
        """Persistent per-(role, dtype) staging, grown but never shrunk."""
        key = (role, np.dtype(dtype).str)
        buf = self._staging.get(key)
        if buf is None or buf.size < nelems:
            buf = np.empty(nelems, dtype=dtype)
            self._staging[key] = buf
            _COLL["staging_allocs"].inc()
        return buf

    # -- topology (two-level selection over HierComm) ----------------------

    def _hier_parts(self) -> tuple[tuple[int, ...], tuple[int, ...]] | None:
        """``(intra_pids, leader_pids)`` when this group's topology is
        non-flat, else ``None``.

        Derived (once, cached) from the context's ``node_ids`` — only the
        composite transport exposes it.  ``intra_pids`` are this rank's
        node-mates in group order (leader first), ``leader_pids`` the
        first group-order member of every node in first-appearance order;
        both are pure functions of ``(ranks, node_ids)``, so every member
        computes the identical partition with zero communication.  Flat
        means: no topology, a single node, or every node a singleton
        (two-level would only add hops)."""
        topo = self._topo
        if topo is _TOPO_UNSET:
            node_ids = getattr(self.ctx, "node_ids", None)
            if node_ids is None:
                topo = None
            else:
                nodes: dict[int, list[int]] = {}
                for pid in self.ranks:
                    nodes.setdefault(node_ids[pid], []).append(pid)
                if len(nodes) < 2 or all(len(m) == 1 for m in nodes.values()):
                    topo = None
                else:
                    topo = (tuple(nodes[node_ids[self.ctx.pid]]),
                            tuple(m[0] for m in nodes.values()))
            self._topo = topo
        return topo

    def _node_granks(self) -> list[list[int]]:
        """Group ranks per node, in node first-appearance (= leader) order
        — the global view a leader needs to address every node's chunks."""
        node_ids = self.ctx.node_ids
        nodes: dict[int, list[int]] = {}
        for g, pid in enumerate(self.ranks):
            nodes.setdefault(node_ids[pid], []).append(g)
        return list(nodes.values())

    def split(self, color: Any, key: int = 0) -> "Group | None":
        """MPI_Comm_split: members with equal ``color`` form a new group,
        ordered by ``(key, group rank)``.  ``color=None`` opts out (the
        rank still participates in the exchange, returns ``None``).

        One allgather of the tiny ``(color, key)`` pairs; the subgroup
        comes from the memoized ``group_of`` cache, so repeated splits
        with the same coloring reuse one ``Group`` and its counters."""
        me = self._require_member()
        infos = self.allgather((color, int(key)), tag=None)
        if color is None:
            return None
        mine = sorted(
            (k, g) for g, (c, k) in enumerate(infos)
            if c is not None and c == color
        )
        return group_of(self.ctx, tuple(self.ranks[g] for _k, g in mine))

    def split_by_node(self) -> "Group":
        """This rank's intra-node subgroup (the whole group when the
        context has no topology) — no communication, unlike ``split``."""
        parts = self._hier_parts()
        if parts is None:
            node_ids = getattr(self.ctx, "node_ids", None)
            if node_ids is None:
                return self
            mine = tuple(p for p in self.ranks
                         if node_ids[p] == node_ids[self.ctx.pid])
            return group_of(self.ctx, mine)
        return group_of(self.ctx, parts[0])

    # -- two-level algorithms ----------------------------------------------
    #
    # Each runs the intra-node leg on this node's subgroup (shm under
    # HierComm) and the inter-node leg on the leaders subgroup (TCP).
    # Sub-phases are plain collectives on subgroups: the intra group is
    # single-node and the leaders group all-singleton, so both are flat
    # by _hier_parts and recursion terminates after one level.  Tags
    # thread the outer call's ``base`` through the subgroups' user-tag
    # namespace — two outer calls never share a base, so interleaved
    # two-level collectives cannot cross-match.

    # Per-node widths where flat intra legs beat a binomial tree: every
    # forwarded tree hop serializes a full park/wake round trip on the
    # fabric, while a wider flat fan-in only costs the leader one more
    # arrival-ordered ring drain (usually amortized into a single wake).
    _INTRA_FLAT_MAX = 8

    @_traced_hier("allreduce")
    def _allreduce_hier(self, value: Any, op: Callable, base, parts) -> Any:
        """Intra-node reduce → leader allreduce → intra-node bcast.  The
        wire leg moves one payload per *node*; the leaders' flat
        allreduce is bitwise identical across leaders and the closing
        bcast copies bytes, so all ranks end bitwise identical.

        At per-node widths (``<= _INTRA_FLAT_MAX``) the intra legs go
        flat — arrival-ordered gather in, linear fan-out back — since a
        tree's forwarding hops serialize wakeups the flat drain
        amortizes; wider nodes keep the logarithmic depth."""
        intra_pids, leader_pids = parts
        intra = group_of(self.ctx, intra_pids)
        leader = intra_pids[0]
        flat = len(intra_pids) <= self._INTRA_FLAT_MAX
        if flat:
            vals = intra.gather(value, root=leader, tag=(base, "i"),
                                algo="flat")
            partial = None
            if self.ctx.pid == leader:
                for v in vals:
                    partial = _combine(op, partial, v)
        else:
            partial = intra.reduce(value, op, root=leader, tag=(base, "i"))
        if self.ctx.pid == leader:
            partial = group_of(self.ctx, leader_pids).allreduce(
                partial, op, tag=(base, "x"))
        return intra.bcast(partial, root=leader, tag=(base, "b"),
                           algo="linear" if flat else None)

    @_traced_hier("bcast")
    def _bcast_hier(self, obj: Any, rootg: int, base, parts) -> Any:
        """Root hands off to its node leader (if distinct), leaders
        broadcast across nodes, every leader fans out within its node."""
        intra_pids, leader_pids = parts
        node_ids = self.ctx.node_ids
        root_pid = self.ranks[rootg]
        root_node = node_ids[root_pid]
        root_leader = next(p for p in self.ranks
                           if node_ids[p] == root_node)
        me = self.ctx.pid
        val = obj
        if root_pid != root_leader:
            if me == root_pid:
                self._send(self.ranks.index(root_leader), (base, "h"), obj)
            elif me == root_leader:
                val = self._recv(rootg, (base, "h"))
        if me in leader_pids:
            val = group_of(self.ctx, leader_pids).bcast(
                val, root=root_leader, tag=(base, "l"))
        val = group_of(self.ctx, intra_pids).bcast(
            val, root=intra_pids[0], tag=(base, "n"))
        return obj if me == root_pid else val

    @_traced_hier("barrier")
    def _barrier_hier(self, base, parts) -> None:
        """Arrive: intra gather to the leader; leaders run the flat
        dissemination barrier; release: intra bcast.  No rank passes the
        leaders phase before every rank has arrived."""
        intra_pids, leader_pids = parts
        intra = group_of(self.ctx, intra_pids)
        leader = intra_pids[0]
        intra.gather(None, root=leader, tag=(base, "in"))
        if self.ctx.pid == leader:
            group_of(self.ctx, leader_pids).barrier(tag=(base, "x"))
        intra.bcast(None, root=leader, tag=(base, "out"))

    @_traced_hier("allgather")
    def _allgather_hier(self, obj: Any, base, parts) -> list:
        """Intra gather → leaders allgather (payloads ride with their
        outer group ranks) → leader assembles → intra bcast."""
        intra_pids, leader_pids = parts
        intra = group_of(self.ctx, intra_pids)
        leader = intra_pids[0]
        vals = intra.gather(obj, root=leader, tag=(base, "g"))
        if self.ctx.pid == leader:
            granks = tuple(self.ranks.index(p) for p in intra_pids)
            out: list[Any] = [None] * self.size
            for gr, vs in group_of(self.ctx, leader_pids).allgather(
                    (granks, vals), tag=(base, "x")):
                for g, v in zip(gr, vs):
                    out[g] = v
        else:
            out = None
        return intra.bcast(out, root=leader, tag=(base, "b"))

    @_traced_hier("reduce_scatter")
    def _reduce_scatter_hier(self, arr: np.ndarray, op: Callable, base,
                             parts) -> np.ndarray:
        """Intra reduce of the full vector to the leader, then a leaders
        alltoallv exchanging only each destination node's chunk slices
        (1/P of the vector per member crosses the wire, not the whole
        vector), leader combines per-member partials in leader order and
        scatters each node-mate its chunk."""
        intra_pids, leader_pids = parts
        intra = group_of(self.ctx, intra_pids)
        leader = intra_pids[0]
        me = self.ctx.pid
        flat = np.ascontiguousarray(arr).reshape(-1)
        bounds = self._split_bounds(flat.size, self.size)
        partial = intra.reduce(flat, op, root=leader, tag=(base, "i"))
        if me != leader:
            return np.asarray(
                self._recv(self.ranks.index(leader), (base, "s")))
        node_granks = self._node_granks()
        sendlist = [
            [partial[bounds[g]: bounds[g + 1]] for g in granks]
            for granks in node_granks
        ]
        got = group_of(self.ctx, leader_pids).alltoallv(
            sendlist, tag=(base, "x"))
        mine: np.ndarray | None = None
        for k, pid in enumerate(intra_pids):
            acc = None
            for per_member in got:
                acc = _combine(op, acc, per_member[k])
            if pid == me:
                mine = np.asarray(acc)
            else:
                self._send(self.ranks.index(pid), (base, "s"), acc)
        return mine

    # -- broadcast ---------------------------------------------------------

    @_traced_coll("bcast")
    def bcast(self, obj: Any = None, root: int | None = None, tag: Any = None,
              algo: str | None = None) -> Any:
        me = self._require_member()
        rootg = self._root_rank(root)
        if self.size == 1:
            return obj
        base = self._base_tag("bc", tag)
        if algo is None and hasattr(self.ctx, "onefile_bcast"):
            algo = "onefile"
        if algo is None:
            parts = self._hier_parts()
            if parts is not None:
                return self._bcast_hier(obj, rootg, base, parts)
        if algo == "onefile":
            return self.ctx.onefile_bcast(self.ranks[rootg], obj, base, self.ranks)
        if algo == "linear":
            return self._bcast_linear(obj, rootg, base)
        # the root picks eager-tree vs chunked-ring from the payload it
        # alone can see; with the ring, a tiny tree-broadcast header tells
        # everyone the transfer shape first (log-P small messages)
        if me == rootg:
            byref = getattr(self.ctx, "payload_by_reference", False)
            if algo is None:
                # in-process, a broadcast is one immutable buffer read by
                # everyone (the ThreadComm analogue of FileMPI's one-file
                # trick): frozen-tree beats the chunked ring at every size
                if byref and isinstance(obj, np.ndarray):
                    algo = "tree"
                else:
                    algo = select_bcast(payload_nbytes(obj), self.size,
                                        eager=self._eager())
            if _trace.enabled:
                _trace.instant("coll.algo", op="bcast", algo=algo)
            if algo == "tree":
                if byref and isinstance(obj, np.ndarray):
                    # ONE pinning copy at the root; the frozen buffer then
                    # travels by reference (receivers get read-only views
                    # — .copy() to own).  Already-frozen inputs travel
                    # with zero copies.
                    self._bcast_tree(("e", _frozen_owned(obj)), rootg, base)
                    return obj
                return self._bcast_tree(("e", obj), rootg, base)[1]
            if not isinstance(obj, np.ndarray):
                raise ValueError("ring bcast requires an ndarray payload")
            arr = np.asarray(obj)
            nchunks = self._ring_chunks(arr.nbytes)
            self._bcast_tree(("r", nchunks, arr.shape, arr.dtype), rootg, base)
            return self._bcast_ring(arr, rootg, base, nchunks)
        head = self._bcast_tree(None, rootg, base)
        if head[0] == "e":
            return head[1]
        _, nchunks, shape, dtype = head
        out = self._bcast_ring(None, rootg, base, nchunks,
                               shape=shape, dtype=dtype)
        return out.reshape(shape)

    def _bcast_linear(self, obj: Any, rootg: int, base) -> Any:
        """The seed algorithm: serialized fan-out from the root (O(P) at
        the root).  Kept as the benchmark baseline."""
        if self.rank == rootg:
            for dst in range(self.size):
                if dst != rootg:
                    self._send(dst, (base, "lin"), obj)
            return obj
        return self._recv(rootg, (base, "lin"))

    def _bcast_tree(self, obj: Any, rootg: int, base) -> Any:
        """Binomial tree rooted at group rank ``rootg``: ceil(log2 P)
        rounds, every rank forwards to at most log P children."""
        rel = (self.rank - rootg) % self.size
        mask = 1
        while mask < self.size:
            if rel & mask:
                obj = self._recv((rel - mask + rootg) % self.size, (base, "t"))
                break
            mask <<= 1
        mask >>= 1
        while mask:
            if rel + mask < self.size:
                self._send((rel + mask + rootg) % self.size, (base, "t"), obj)
            mask >>= 1
        return obj

    def _ring_chunks(self, nbytes: int) -> int:
        chunk = max(self._eager(), 1)
        return max(1, min(_MAX_RING_CHUNKS, -(-nbytes // chunk)))

    @staticmethod
    def _split_bounds(n: int, k: int) -> list[int]:
        """The k+1 boundaries ``np.array_split`` uses for n elements —
        shared by sender and receivers so piece views line up."""
        sizes = [n // k + 1] * (n % k) + [n // k] * (k - n % k)
        bounds = [0]
        for s in sizes:
            bounds.append(bounds[-1] + s)
        return bounds

    def _bcast_ring(self, arr: np.ndarray | None, rootg: int, base,
                    nchunks: int, shape=None, dtype=None) -> np.ndarray:
        """Pipelined chain in relative-rank order: the root streams chunks
        to its successor; every rank forwards each chunk as it lands, so
        steady state moves the whole payload once per rank, overlapped.

        Non-root ranks land every piece straight into their (single)
        output allocation via ``irecv_into`` — no per-piece receive
        buffers and no final concatenate."""
        rel = (self.rank - rootg) % self.size
        nxt = (rel + 1 + rootg) % self.size
        if rel == 0:
            flat = np.ascontiguousarray(arr).reshape(-1)
            for i, piece in enumerate(np.array_split(flat, nchunks)):
                self._send(nxt, (base, "c", i), piece)
            return arr
        n = 1
        for d in shape:
            n *= d
        out = np.empty(n, dtype=dtype)
        bounds = self._split_bounds(n, nchunks)
        for i in range(nchunks):
            piece = out[bounds[i] : bounds[i + 1]]
            self._recv_into((rel - 1 + rootg) % self.size, (base, "c", i),
                            piece)
            if rel + 1 < self.size:
                self._send(nxt, (base, "c", i), piece)
        return out

    # -- reduce ------------------------------------------------------------

    @_traced_coll("reduce")
    def reduce(self, value: Any, op: Callable, root: int | None = None,
               tag: Any = None) -> Any:
        """Binomial-tree reduction to ``root`` (commutative ``op``); the
        root returns the reduced value, everyone else ``None``."""
        self._require_member()
        rootg = self._root_rank(root)
        if self.size == 1:
            return value
        base = self._base_tag("red", tag)
        rel = (self.rank - rootg) % self.size
        acc = value
        mask = 1
        while mask < self.size:
            if rel & mask:
                self._send((rel - mask + rootg) % self.size, (base, "r"), acc)
                return None
            partner = rel | mask
            if partner < self.size:
                other = self._recv((partner + rootg) % self.size, (base, "r"))
                acc = _combine(op, acc, other)
            mask <<= 1
        return acc

    # -- gather ------------------------------------------------------------

    @_traced_coll("gather")
    def gather(self, obj: Any, root: int | None = None, tag: Any = None,
               algo: str | None = None) -> list | None:
        me = self._require_member()
        rootg = self._root_rank(root)
        if self.size == 1:
            return [obj]
        base = self._base_tag("ga", tag)
        if algo is None:
            algo = select_gather(self.size)
        if _trace.enabled:
            _trace.instant("coll.algo", op="gather", algo=algo)
        if algo == "tree":
            return self._gather_tree(obj, rootg, base)
        # flat: one isend per child, the root completes receives in
        # *arrival* order — one slow rank never serializes the others
        if me != rootg:
            self._send(rootg, (base, "f", me), obj)
            return None
        parts: list[Any] = [None] * self.size
        parts[rootg] = obj
        others = [g for g in range(self.size) if g != rootg]
        reqs = [self._irecv(src, (base, "f", src)) for src in others]
        for src, val in zip(others, self.ctx.wait_all(reqs)):
            parts[src] = val
        return parts

    def _gather_tree(self, obj: Any, rootg: int, base) -> list | None:
        rel = (self.rank - rootg) % self.size
        acc = {self.rank: obj}
        mask = 1
        while mask < self.size:
            if rel & mask:
                self._send((rel - mask + rootg) % self.size, (base, "t"), acc)
                return None
            partner = rel | mask
            if partner < self.size:
                acc.update(self._recv((partner + rootg) % self.size, (base, "t")))
            mask <<= 1
        return [acc[g] for g in range(self.size)]

    # -- allgather ---------------------------------------------------------

    @_traced_coll("allgather")
    def allgather(self, obj: Any, tag: Any = None,
                  algo: str | None = None) -> list:
        me = self._require_member()
        if self.size == 1:
            return [obj]
        base = self._base_tag("ag", tag)
        if algo is None:
            parts = self._hier_parts()
            if parts is not None:
                return self._allgather_hier(obj, base, parts)
            algo = select_allgather(self.size)
        if algo == "gatherbcast":
            # seed baseline: gather to group rank 0, then broadcast the
            # whole assembled list — O(P·S) through one root
            parts = self.gather(obj, root=self.ranks[0], tag=(base, "g"))
            return self.bcast(parts, root=self.ranks[0], tag=(base, "b"),
                              algo="linear")
        if algo == "rd":
            if self.size & (self.size - 1):
                raise ValueError(
                    "recursive-doubling allgather needs a power-of-two "
                    f"group (size {self.size}); use algo='ring'"
                )
            acc = {me: obj}
            mask = 1
            while mask < self.size:
                partner = me ^ mask
                self._send(partner, (base, "rd", mask), acc)
                acc.update(self._recv(partner, (base, "rd", mask)))
                mask <<= 1
            return [acc[g] for g in range(self.size)]
        # ring: P-1 steps, each rank forwards the newest block to its
        # successor — works for any group size.  Received blocks are
        # frozen so forwarding travels by reference: on by-reference
        # transports the returned entries (except this rank's own) are
        # read-only — .copy() to own.
        parts: list[Any] = [None] * self.size
        parts[me] = obj
        right, left = (me + 1) % self.size, (me - 1) % self.size
        for step in range(self.size - 1):
            si = (me - step) % self.size
            ri = (me - 1 - step) % self.size
            self._send(right, (base, "rg", step), parts[si])
            parts[ri] = self._freeze_hop(self._recv(left, (base, "rg", step)))
        return parts

    # -- allreduce ---------------------------------------------------------

    @_traced_coll("allreduce")
    def allreduce(self, value: Any, op: Callable, tag: Any = None,
                  algo: str | None = None) -> Any:
        """Reduce ``value`` with commutative ``op`` and deliver the result
        to every member.  Long ndarray payloads take the bandwidth-optimal
        ring (``op`` must then be elementwise, e.g. ``np.add``); everything
        else recursive doubling."""
        me = self._require_member()
        if self.size == 1:
            return value
        base = self._base_tag("ar", tag)
        if algo is None:
            parts = self._hier_parts()
            if parts is not None:
                return self._allreduce_hier(value, op, base, parts)
        shape = None
        staged = False
        if algo is None:
            # contributions may be None or ragged (empty Dmat parts), so a
            # locally-selected algorithm could differ across ranks and
            # deadlock; the group leader decides from its own payload and
            # ships the choice — plus the output shape the ring needs —
            # down a tiny tree header
            if me == 0:
                algo = select_allreduce(payload_nbytes(value), self.size,
                                        eager=self._eager())
                head = ((algo, value.shape, value.dtype) if algo == "ring"
                        else (algo,))
            else:
                head = None
            head = self._bcast_tree(head, 0, (base, "alg"))
            algo = head[0]
            if algo == "ring":
                shape = head[1]
                # the staged (allocation-free, irecv_into) ring needs an
                # ndarray on EVERY rank; a tiny reduce-then-bcast of the
                # None flags decides it group-wide — two log-P legs of
                # ~40-byte messages on a path already moving megabytes
                any_none = self.reduce(value is None, lambda a, b: a or b,
                                       root=self.ranks[0], tag=(base, "nn"))
                staged = self._bcast_tree(
                    (not any_none) if me == 0 else None, 0, (base, "st"))
        elif algo == "ring":
            # forced ring: every rank below raises on a None contribution,
            # so reaching the hops at all implies ndarrays everywhere
            staged = value is not None
        if getattr(self.ctx, "payload_by_reference", False):
            # staging buys nothing by-reference: every staged hop would
            # pay a _pin copy on send AND a landing copy, while the
            # unstaged ring circulates frozen received buffers for free —
            # keep the reference-forwarding path there
            staged = False
        if _trace.enabled:
            _trace.instant("coll.algo", op="allreduce", algo=algo,
                           staged=staged)
        if algo == "gather":
            # seed baseline: allgather every contribution, reduce
            # redundantly on all P ranks
            vals = [v for v in self.allgather(value, tag=(base, "g"),
                                              algo="gatherbcast")
                    if v is not None]
            if not vals:
                return None
            acc = vals[0]
            for v in vals[1:]:
                acc = op(acc, v)
            return acc
        if algo == "ring":
            if value is None and shape is None:
                # only auto mode ships the leader's shape header, so a
                # forced ring cannot reconstruct this rank's output shape
                raise ValueError(
                    "algo='ring' allreduce needs an ndarray contribution "
                    "on every rank; use auto mode for None contributions"
                )
            return self._allreduce_ring(value, op, base, shape=shape,
                                        staged=staged)
        return self._allreduce_rd(value, op, base)

    def _allreduce_rd(self, value: Any, op: Callable, base) -> Any:
        """Recursive doubling with the standard non-power-of-two folding:
        the first 2·rem ranks pair-fold down to a power-of-two active set,
        exchange log2 rounds, then unfold."""
        me = self.rank
        pof2 = 1
        while pof2 * 2 <= self.size:
            pof2 *= 2
        rem = self.size - pof2
        if me < 2 * rem:
            if me % 2 == 0:
                self._send(me + 1, (base, "fold"), value)
                newrank = -1
            else:
                value = _combine(op, self._recv(me - 1, (base, "fold")), value)
                newrank = me // 2
        else:
            newrank = me - rem
        if newrank != -1:
            mask = 1
            while mask < pof2:
                pn = newrank ^ mask
                partner = pn * 2 + 1 if pn < rem else pn + rem
                self._send(partner, (base, "x", mask), value)
                other = self._recv(partner, (base, "x", mask))
                # rank-ordered operands: both partners compute the same
                # grouping, so every rank ends bitwise identical
                if partner < me:
                    value = _combine(op, other, value)
                else:
                    value = _combine(op, value, other)
                mask <<= 1
        if me < 2 * rem:
            if me % 2:
                self._send(me - 1, (base, "unfold"), value)
            else:
                value = self._recv(me + 1, (base, "unfold"))
        return value

    def _allreduce_ring(self, arr, op: Callable, base, shape=None,
                        staged: bool = False) -> np.ndarray:
        """Ring reduce-scatter + ring allgather: 2·(P-1)/P of the payload
        through every rank regardless of P (vs. the seed baseline's P·S
        through the root and (P-1)·S reduced on every rank).

        ``staged`` (every rank holds an ndarray — decided group-wide by
        the caller) runs the hops **allocation-free**: the vector lives
        in a persistent per-group work buffer, every hop receives into a
        persistent staging chunk via ``irecv_into`` (serializing
        transports decode payload bytes straight into it), the combine
        runs in place for ufuncs, and the allgather lap lands directly
        in the work buffer's chunk views.  The only per-call allocation
        is the returned result.

        Unstaged, a rank may contribute ``None`` (empty Dmat part): it
        circulates None chunks — skipped by the combine step — and
        reshapes via the leader-shipped ``shape``.  (Auto mode only
        selects the ring when the *leader* holds an array, so every
        chunk resolves.)"""
        if staged:
            return self._allreduce_ring_staged(np.asarray(arr), op, base)
        if arr is None:
            chunks: list = [None] * self.size
        else:
            arr = np.asarray(arr)
            shape = arr.shape
            flat = arr.reshape(-1)
            chunks = list(np.array_split(flat, self.size))
        chunks = self._ring_reduce_scatter(chunks, op, base)
        if (getattr(self.ctx, "payload_by_reference", False)
                and chunks[self.rank] is not None):
            # my reduced chunk is final — freeze it so the allgather lap
            # circulates references, not per-hop copies
            chunks[self.rank] = _frozen_owned(np.asarray(chunks[self.rank]))
        chunks = self._ring_allgather_chunks(chunks, base)
        out = np.concatenate(chunks)
        return out if shape is None else out.reshape(shape)

    def _allreduce_ring_staged(self, arr: np.ndarray, op: Callable,
                               base) -> np.ndarray:
        shape = arr.shape
        n = arr.size
        me = self.rank
        right, left = (me + 1) % self.size, (me - 1) % self.size
        work = self._staging_buf("ar_work", n, arr.dtype)[:n]
        np.copyto(work.reshape(shape), arr)
        chunks = np.array_split(work, self.size)  # contiguous views
        hop = self._staging_buf(
            "ar_hop", max(c.size for c in chunks), arr.dtype)
        for step in range(self.size - 1):
            si = (me - 1 - step) % self.size
            ri = (me - 2 - step) % self.size
            self._send(right, (base, "rs", step), chunks[si])
            h = hop[: chunks[ri].size]
            self._recv_into(left, (base, "rs", step), h)
            if isinstance(op, np.ufunc):
                op(chunks[ri], h, out=chunks[ri])
            else:
                # op may return (a view of) either operand; copyto
                # materializes the result before the staging is reused
                np.copyto(chunks[ri], op(chunks[ri], h))
        for step in range(self.size - 1):
            si = (me - step) % self.size
            ri = (me - 1 - step) % self.size
            self._send(right, (base, "rag", step), chunks[si])
            self._recv_into(left, (base, "rag", step), chunks[ri])
        return work.copy().reshape(shape)

    def _ring_reduce_scatter(self, chunks: list, op: Callable, base) -> list:
        """P-1 ring steps; afterwards ``chunks[self.rank]`` holds the fully
        reduced chunk for this rank."""
        me = self.rank
        right, left = (me + 1) % self.size, (me - 1) % self.size
        for step in range(self.size - 1):
            si = (me - 1 - step) % self.size
            ri = (me - 2 - step) % self.size
            self._send(right, (base, "rs", step), chunks[si])
            chunks[ri] = _combine(op, chunks[ri],
                                  self._recv(left, (base, "rs", step)))
            _COLL["ring_hops_alloc"].inc()
        return chunks

    def _ring_allgather_chunks(self, chunks: list, base) -> list:
        me = self.rank
        right, left = (me + 1) % self.size, (me - 1) % self.size
        for step in range(self.size - 1):
            si = (me - step) % self.size
            ri = (me - 1 - step) % self.size
            self._send(right, (base, "rag", step), chunks[si])
            chunks[ri] = self._freeze_hop(self._recv(left, (base, "rag", step)))
            _COLL["ring_hops_alloc"].inc()
        return chunks

    # -- reduce_scatter ----------------------------------------------------

    @_traced_coll("reduce_scatter")
    def reduce_scatter(self, value: np.ndarray, op: Callable,
                       tag: Any = None,
                       algo: str | None = None) -> np.ndarray:
        """Elementwise-reduce ``value`` across the group and return this
        rank's chunk (``np.array_split`` of the flattened result).
        ``algo="ring"`` forces the flat ring; auto mode goes two-level on
        a non-flat topology."""
        self._require_member()
        arr = np.asarray(value)
        if self.size == 1:
            return arr.reshape(-1)
        base = self._base_tag("rs", tag)
        if algo is None:
            parts = self._hier_parts()
            if parts is not None:
                return self._reduce_scatter_hier(arr, op, base, parts)
        chunks = list(np.array_split(arr.reshape(-1), self.size))
        return self._ring_reduce_scatter(chunks, op, base)[self.rank]

    # -- alltoallv ---------------------------------------------------------

    @_traced_coll("alltoallv")
    def alltoallv(self, sendlist: Sequence[Any], tag: Any = None) -> list:
        """Personalized exchange: ``sendlist[g]`` goes to group rank ``g``;
        returns the payloads received, indexed by source group rank.
        Rotated pairwise schedule (step s pairs rank r with r±s), receives
        completed in arrival order."""
        me = self._require_member()
        if len(sendlist) != self.size:
            raise ValueError(
                f"alltoallv needs one payload per member "
                f"({len(sendlist)} != {self.size})"
            )
        out: list[Any] = [None] * self.size
        out[me] = _pin(self.ctx, sendlist[me])
        if self.size == 1:
            return out
        base = self._base_tag("a2a", tag)
        sources, reqs = [], []
        for step in range(1, self.size):
            dst = (me + step) % self.size
            src = (me - step) % self.size
            self._send(dst, (base, "p"), sendlist[dst])
            sources.append(src)
            reqs.append(self._irecv(src, (base, "p")))
        for src, val in zip(sources, self.ctx.wait_all(reqs)):
            out[src] = val
        return out

    # -- barrier -----------------------------------------------------------

    @_traced_coll("barrier")
    def barrier(self, tag: Any = None, algo: str | None = None) -> None:
        """Dissemination barrier: ceil(log2 P) rounds, no root.  The seed
        ``central`` gather-and-release survives as the benchmark baseline."""
        me = self._require_member()
        if self.size == 1:
            return
        base = self._base_tag("bar", tag)
        if algo is None:
            parts = self._hier_parts()
            if parts is not None:
                return self._barrier_hier(base, parts)
        if algo == "central":
            if me == 0:
                for src in range(1, self.size):
                    self._recv(src, (base, "in"))
                for dst in range(1, self.size):
                    self._send(dst, (base, "out"), None)
            else:
                self._send(0, (base, "in"), None)
                self._recv(0, (base, "out"))
            return
        dist, k = 1, 0
        while dist < self.size:
            self._send((me + dist) % self.size, (base, k), None)
            self._recv((me - dist) % self.size, (base, k))
            dist <<= 1
            k += 1


# ---------------------------------------------------------------------------
# Group construction / caching
# ---------------------------------------------------------------------------


def group_of(ctx: CommContext, ranks: Sequence[int]) -> Group:
    """Memoized ``Group`` for a rank tuple (per-context cache, so repeated
    collectives on one Dmap reuse the group and its tag counters)."""
    key = tuple(int(r) for r in ranks)
    cache = getattr(ctx, "_pp_groups", None)
    if cache is None:
        cache = ctx._pp_groups = {}
    g = cache.get(key)
    if g is None:
        g = cache[key] = Group(ctx, key)
    return g


def world_group(ctx: CommContext) -> Group:
    """The group of every rank in ``ctx`` (MPI_COMM_WORLD)."""
    return group_of(ctx, range(ctx.np_))
