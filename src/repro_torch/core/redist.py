"""Redistribution engine v3: memoized PITFALLS plans + compiled execution
schedules (paper §III.C).

``Z[:, :] = X`` is pPython's communication operator, and the follow-up
performance study (arXiv:2309.03931) splits its cost into *schedule
computation* — the O(P²·ndim) PITFALLS intersection deciding who sends
which indices to whom — and *data movement*.  The schedule depends only on
``(src map, dst map, shapes, region, rank)``, none of which change across
the iterations of an FFT corner-turn or a halo-exchange loop, so it is
computed once per key and cached here (pMatlab computed its communication
schedules once per map pair a generation ago; this module is the pPython
equivalent).

A cached :class:`RedistPlan` holds, for the owning rank: the local source
positions of every outbound block, the local destination positions of
every inbound block, the self-copy positions, and a *deterministic*
message tag (SHA-1 of the canonical key — ``hash()`` is salted per
process and would desync FileMPI ranks).

Steady-state execution is a *compiled schedule* (engine v3), built once
per plan from the index arrays and reused every iteration:

* **One message per communicating peer pair** — every block bound for a
  peer is coalesced into a single packed payload, so a redistribution
  costs O(peers) messages, never O(blocks).
* **Slice-view zero-copy fast paths** — when a block's per-dim index
  arrays form contiguous/strided ranges or regular segment families
  (block, cyclic, and exact block-cyclic intersections all do), the
  ``np.ix_`` fancy gather/scatter lowers to strided *views*: contiguous
  sends go to the transport as zero-copy buffer exports (riding the
  pickle-5 out-of-band framing of the serializing transports), and
  contiguous receives land **directly inside ``dst.local``** via
  ``irecv_into`` — no intermediate buffer at all.
* **Persistent per-peer staging buffers** — non-contiguous packs and
  unpacks go through plan-owned staging arrays that are allocated once
  and reused across iterations (``np.take`` with ``out=``/vectorized
  segment copies instead of fancy-index temporaries), so the steady
  state allocates nothing.

Ragged index sets (e.g. block-cyclic remainders, arbitrary cyclic
subsets) fall back to a precomputed flat-index pack/unpack; the naive v2
executor is kept as ``execute_naive`` and selected by
``PPYTHON_REDIST_COALESCE=0`` for debugging and benchmarking.  Message,
byte, and copy counters (see :func:`plan_cache_stats` /
:func:`exec_stats`) make the data-movement savings observable.

The per-(map, shape, rank) owned-index arrays are cached here too and
shared with ``Dmat`` and ``scatter`` — constructing many arrays under one
map (the common SPMD pattern) pays the index bookkeeping once.

The port's own copy of ``repro.core.redist`` (NumPy only): the
checkpoint's reads use its disk-side FALLS helpers (``as_basic_index``,
``segment_intersection``, ``owned_segment_positions``).
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .dmap import Dmap
from .pitfalls import falls_list_indices, falls_list_intersect

__all__ = [
    "RedistPlan",
    "redistribute",
    "get_plan",
    "plan_cache_stats",
    "exec_stats",
    "reset_exec_stats",
    "clear_plan_cache",
    "owned_indices_cached",
    "halo_extents_cached",
    "segment_intersection",
    "owned_segment_positions",
    "as_basic_index",
]


# ---------------------------------------------------------------------------
# Small thread-safe LRU (ThreadComm runs all ranks in one process)
# ---------------------------------------------------------------------------


class _LRU:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


def _cache_size(env: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(env, default)))
    except ValueError:
        return default


_plan_cache = _LRU(_cache_size("PPYTHON_PLAN_CACHE_SIZE", 128))
_owned_cache = _LRU(_cache_size("PPYTHON_INDEX_CACHE_SIZE", 512))
_halo_cache = _LRU(_cache_size("PPYTHON_INDEX_CACHE_SIZE", 512))


def owned_indices_cached(
    dmap: Dmap, shape: tuple[int, ...], pid: int
) -> tuple[np.ndarray, ...]:
    """Per-dim sorted owned global indices of ``pid`` (cached, shared)."""
    key = (dmap, shape, pid)
    got = _owned_cache.get(key)
    if got is None:
        if dmap.inmap(pid):
            got = tuple(
                dmap.local_indices(shape, d, pid) for d in range(dmap.ndim)
            )
        else:
            got = tuple(np.empty(0, dtype=np.int64) for _ in shape)
        for arr in got:
            # the arrays are shared by every Dmat under this (map, shape,
            # rank): freeze them so a consumer can't silently corrupt the
            # index bookkeeping of its siblings
            arr.setflags(write=False)
        _owned_cache.put(key, got)
    return got


def halo_extents_cached(
    dmap: Dmap, shape: tuple[int, ...], pid: int
) -> tuple[int, ...]:
    """Per-dim halo extents of ``pid`` (cached, shared)."""
    key = (dmap, shape, pid)
    got = _halo_cache.get(key)
    if got is None:
        if dmap.inmap(pid):
            got = tuple(
                dmap.halo_extent(shape, d, pid) for d in range(dmap.ndim)
            )
        else:
            got = tuple(0 for _ in shape)
        _halo_cache.put(key, got)
    return got


# ---------------------------------------------------------------------------
# Execution statistics (message/byte/copy counters, aggregated over the
# in-process ranks exactly like the plan cache)
# ---------------------------------------------------------------------------


_STAT_KEYS = (
    "messages",           # point-to-point messages posted by execute()
    "bytes",              # payload bytes across those messages
    "copies",             # gather/scatter/pack/unpack memcpy-equivalents
    "sends_zero_copy",    # contiguous view handed to the transport as-is
    "sends_packed",       # packed through a staging buffer (view or flat)
    "sends_fancy",        # ragged index set: flat-index pack
    "recvs_direct",       # landed straight inside dst.local (irecv_into)
    "recvs_staged",       # landed in plan staging, then strided unpack
    "recvs_fancy",        # ragged index set: flat-index unpack
    "naive_executions",   # execute() calls routed to the v2 naive path
)


# The counters live in the process-wide obs.metrics registry under the
# "redist." prefix; exec_stats() is a view over them.
_EXEC = {k: _metrics.counter("redist." + k) for k in _STAT_KEYS}


def _exec_add(**deltas: int) -> None:
    for k, v in deltas.items():
        _EXEC[k].inc(v)


def exec_stats() -> dict[str, int]:
    """Data-movement counters of the execution engine (benchmark hook) —
    a view over the ``redist.*`` counters in ``repro.obs.metrics``."""
    return {k: c.value for k, c in _EXEC.items()}


def reset_exec_stats() -> None:
    """Thin alias of ``repro.obs.metrics.reset()``: one reset zeroes
    every registry metric (redist, collectives, serve) so the three
    legacy reset entry points can never drift apart.  Cached plans are
    untouched."""
    _metrics.reset()


# ---------------------------------------------------------------------------
# Index-set lowering: fancy index arrays -> slices / segment families
# ---------------------------------------------------------------------------
#
# A per-dim descriptor is one of
#   ("slice", start, count, step)                  — basic (strided) slice
#   ("segs",  start, nseg, seg_len, stride)        — regular segment family
#   ("fancy", positions)                           — anything ragged
# Block intersections lower to contiguous slices, cyclic ones to strided
# slices, and exact block-cyclic ones to segment families; only ragged
# sets (e.g. a block-cyclic remainder tail) stay fancy and force the
# flat-index pack/unpack path for their peer.


def _lower_positions(pos: np.ndarray):
    n = len(pos)
    first = int(pos[0])
    if n == 1:
        return ("slice", first, 1, 1)
    d = np.diff(pos)
    step = int(d[0])
    if np.all(d == step):
        return ("slice", first, n, step)
    breaks = np.flatnonzero(d != 1)
    run_lens = np.diff(np.r_[0, breaks + 1, n])
    seg_len = int(run_lens[0])
    if np.all(run_lens == seg_len):
        starts = pos[np.r_[0, breaks + 1]]
        sd = np.diff(starts)
        stride = int(sd[0])
        if np.all(sd == stride) and stride >= seg_len:
            return ("segs", first, len(starts), seg_len, stride)
    return ("fancy", pos)


def _lower_dims(pos_tuple: tuple[np.ndarray, ...]):
    """All-dims descriptors, or None when any dim is ragged."""
    descs = tuple(_lower_positions(p) for p in pos_tuple)
    if any(d[0] == "fancy" for d in descs):
        return None
    return descs


def _expanded_shape(descs) -> tuple[int, ...]:
    shape: list[int] = []
    for d in descs:
        if d[0] == "slice":
            shape.append(d[2])
        else:
            shape.extend((d[2], d[3]))
    return tuple(shape)


def _strided_view(arr: np.ndarray, descs) -> np.ndarray:
    """Strided view of ``arr`` selecting the descriptor cross product.

    Slice dims contribute one view axis; segment dims contribute two
    (segment, element-within-segment).  Pure index arithmetic over the
    array's own strides — never a copy.
    """
    shape: list[int] = []
    strides: list[int] = []
    offset = 0
    for axis, d in enumerate(descs):
        st = arr.strides[axis]
        if d[0] == "slice":
            _, start, count, step = d
            offset += start * st
            shape.append(count)
            strides.append(step * st)
        else:
            _, start, nseg, seg_len, stride = d
            offset += start * st
            shape.extend((nseg, seg_len))
            strides.extend((stride * st, st))
    flat = arr.reshape(-1)  # locals are C-contiguous by construction
    base = flat[offset // arr.itemsize:]
    return np.lib.stride_tricks.as_strided(base, shape=shape, strides=strides)


def _flat_indices(
    pos_tuple: tuple[np.ndarray, ...], local_shape: tuple[int, ...]
) -> np.ndarray:
    """C-order element offsets of the index cross product (ragged path)."""
    strides = np.empty(len(local_shape), dtype=np.int64)
    acc = 1
    for d in range(len(local_shape) - 1, -1, -1):
        strides[d] = acc
        acc *= local_shape[d]
    out = np.zeros((1,) * len(pos_tuple), dtype=np.int64)
    for d, pos in enumerate(pos_tuple):
        shape = [1] * len(pos_tuple)
        shape[d] = len(pos)
        out = out + (pos.astype(np.int64) * strides[d]).reshape(shape)
    return np.ascontiguousarray(out).reshape(-1)


class _Xfer:
    """One peer's compiled transfer: either a strided view over the local
    buffer (``descs``) or a precomputed flat index set (``flat_idx``).

    ``peer_descs`` (receive side only) lowers the *sender's* local
    positions of the same block — what the payload looks like when the
    by-reference zero-copy view path is active."""

    __slots__ = ("peer", "block_shape", "nelems", "descs", "expanded",
                 "flat_idx", "peer_descs")

    def __init__(self, peer: int, pos_tuple, local_shape):
        self.peer = peer
        self.block_shape = tuple(len(p) for p in pos_tuple)
        self.nelems = int(np.prod(self.block_shape))
        self.descs = _lower_dims(pos_tuple)
        self.peer_descs = None
        if self.descs is not None:
            self.expanded = _expanded_shape(self.descs)
            self.flat_idx = None
        else:
            self.expanded = None
            self.flat_idx = _flat_indices(pos_tuple, local_shape)

    def view(self, arr: np.ndarray) -> np.ndarray:
        return _strided_view(arr, self.descs)


def _common_refinement(s_descs, d_descs):
    """Per-dim axis-split plan aligning two factorizations of one block,
    or None when a dim is fragmented differently by both sides.

    Each entry is ``(sender split, receiver split, shape part)``: a side
    whose axis for that dim is a plain (strided) slice can always be
    split to match the other side's ``(nseg, seg_len)`` family, because
    its per-element stride is uniform; two *different* families have no
    common regular refinement.
    """
    plan = []
    for s_d, d_d in zip(s_descs, d_descs):
        s_seg = s_d[0] == "segs"
        d_seg = d_d[0] == "segs"
        if not s_seg and not d_seg:
            plan.append((None, None, (s_d[2],)))
        elif not s_seg:
            n, L = d_d[2], d_d[3]
            plan.append(((n, L), None, (n, L)))
        elif not d_seg:
            n, L = s_d[2], s_d[3]
            plan.append((None, (n, L), (n, L)))
        else:
            if (s_d[2], s_d[3]) != (d_d[2], d_d[3]):
                return None
            plan.append((None, None, (s_d[2], s_d[3])))
    return plan


def _refined_view(view: np.ndarray, descs, plan, side: int) -> np.ndarray:
    """Re-stride ``view`` (one side's expanded block view) to the common
    refined shape — pure axis splitting, never a copy."""
    shape: list[int] = []
    strides: list[int] = []
    ax = 0
    for desc, entry in zip(descs, plan):
        split = entry[side]
        if desc[0] == "segs":
            shape.extend(view.shape[ax:ax + 2])
            strides.extend(view.strides[ax:ax + 2])
            ax += 2
            continue
        st = view.strides[ax]
        if split is None:
            shape.append(view.shape[ax])
            strides.append(st)
        else:
            n, L = split
            shape.extend((n, L))
            strides.extend((L * st, st))
        ax += 1
    return np.lib.stride_tricks.as_strided(view, shape=shape,
                                           strides=strides)


class _CompiledPlan:
    """Per-(src local shape, dst local shape) execution schedule."""

    __slots__ = ("src_shape", "dst_shape", "sends", "recvs", "local")

    def __init__(self, plan: "RedistPlan", src_shape, dst_shape):
        self.src_shape = src_shape
        self.dst_shape = dst_shape
        self.sends = [_Xfer(p, pos, src_shape) for p, pos in plan.sends]
        self.recvs = [_Xfer(p, pos, dst_shape) for p, pos in plan.recvs]
        for xf, spos in zip(self.recvs, plan.recv_src_pos):
            xf.peer_descs = _lower_dims(spos)
        if plan.local_copy is not None:
            s_pos, d_pos = plan.local_copy
            self.local = (_Xfer(-1, s_pos, src_shape),
                          _Xfer(-1, d_pos, dst_shape))
        else:
            self.local = None


def _split_axis(desc, nseg: int, seg_len: int):
    """Refine one descriptor's axis into (nseg, seg_len) sub-axes of
    (shape extension, per-element stride multipliers), or None when the
    descriptor's own segmentation is incompatible with the split."""
    if desc[0] == "slice":
        _, start, count, step = desc
        if count != nseg * seg_len:
            return None
        return (start, (nseg, seg_len), (seg_len * step, step))
    _, start, n, L, stride = desc
    if (n, L) != (nseg, seg_len):
        return None  # differently-shaped families: no common refinement
    return (start, (n, L), (stride, 1))


def _pair_views(src_arr, s_descs, dst_arr, d_descs):
    """Same-shaped strided views over source and destination selecting
    the transferred block, or None when the two sides' per-dim
    segmentations have no common regular refinement.

    This is what turns a self-copy (and any same-process transfer) into
    a *single* vectorized traversal — no intermediate pack — whenever at
    most one side fragments each dimension, which covers every
    block/cyclic/block-cyclic corner-turn and halo pattern.
    """

    def factor(desc, other):
        # axis plan for one dim: (start, shape part, element-stride part);
        # a dim the other side fragments must split to match it
        if other[0] == "segs":
            return _split_axis(desc, other[2], other[3])
        if desc[0] == "slice":
            _, start, count, step = desc
            return (start, (count,), (step,))
        _, start, n, L, stride = desc
        return (start, (n, L), (stride, 1))

    shape: list[int] = []
    s_strides: list[int] = []
    d_strides: list[int] = []
    s_off = d_off = 0
    for dim, (s_d, d_d) in enumerate(zip(s_descs, d_descs)):
        sp = factor(s_d, d_d)
        dp = factor(d_d, s_d)
        if sp is None or dp is None or sp[1] != dp[1]:
            return None
        shape.extend(sp[1])
        s_off += sp[0] * src_arr.strides[dim]
        d_off += dp[0] * dst_arr.strides[dim]
        s_strides.extend(m * src_arr.strides[dim] for m in sp[2])
        d_strides.extend(m * dst_arr.strides[dim] for m in dp[2])
    s_base = src_arr.reshape(-1)[s_off // src_arr.itemsize:]
    d_base = dst_arr.reshape(-1)[d_off // dst_arr.itemsize:]
    sv = np.lib.stride_tricks.as_strided(s_base, shape=shape,
                                         strides=s_strides)
    dv = np.lib.stride_tricks.as_strided(d_base, shape=shape,
                                         strides=d_strides)
    return sv, dv


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def _canonical(dmap: Dmap) -> tuple:
    return (dmap.grid, dmap.dist, dmap.proclist, dmap.overlap, dmap.order)


def _stable_tag(src_dmap, dst_dmap, src_shape, dst_shape, region) -> str:
    """Process-independent message tag for one (map pair, shapes, region).

    Must hash identically on every FileMPI rank (separate processes), so
    it digests a canonical repr rather than using the salted ``hash()``.
    """
    blob = repr(
        (_canonical(src_dmap), _canonical(dst_dmap), src_shape, dst_shape, region)
    )
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def _positions(owned: np.ndarray, gidx: np.ndarray, dim: int, pid: int) -> np.ndarray:
    """Local storage positions of owned global indices (validated)."""
    pos = np.searchsorted(owned, gidx)
    if np.any(pos >= len(owned)) or np.any(owned[pos] != gidx):
        raise IndexError(
            f"global indices not owned by rank {pid} along dim {dim}"
        )
    return pos


# ---------------------------------------------------------------------------
# Disk-layout intersection (checkpoint resharding)
# ---------------------------------------------------------------------------
#
# A checkpoint shard on disk is one more FALLS-described index set: the
# same algebra that plans live redistribution decides which bytes of
# which file a rank must read when it restores under a *different* map.
# The checkpoint layer (train/checkpoint.py) routes through these
# helpers so disk resharding and Dmat redistribution share one index
# path (DESIGN.md §4, §8).


def segment_intersection(
    want_falls: list[list], seg_falls: list[list]
) -> tuple[tuple[np.ndarray, ...], tuple[np.ndarray, ...]] | None:
    """Positions of ``want ∩ segment`` relative to each side, per dim.

    Both arguments are per-dim ``list[FALLS]`` in *global* index space
    (``want_falls`` the indices the reader wants in its output buffer,
    ``seg_falls`` the indices one on-disk segment holds along its file
    axes).  Returns ``(want_pos, file_pos)`` — per-dim int64 position
    arrays into the want-side index list and the segment file — or
    ``None`` when the intersection is empty along any dimension (the
    file need not be opened at all)."""
    want_pos, file_pos = [], []
    for wf, sf in zip(want_falls, seg_falls):
        inter = falls_list_intersect(wf, sf)
        gidx = falls_list_indices(inter)
        if gidx.size == 0:
            return None
        # inter ⊆ both sides, so searchsorted positions are exact
        want_pos.append(np.searchsorted(falls_list_indices(wf), gidx))
        file_pos.append(np.searchsorted(falls_list_indices(sf), gidx))
    return tuple(want_pos), tuple(file_pos)


def owned_segment_positions(
    dmap: Dmap, shape: tuple[int, ...], pid: int, seg_falls: list[list]
) -> tuple[tuple[np.ndarray, ...], tuple[np.ndarray, ...]] | None:
    """Like :func:`segment_intersection` with the want side taken from
    ``pid``'s owned indices under ``dmap`` — positions are validated
    against the shared owned-index cache, so the returned ``local_pos``
    indexes the rank's owned local storage (sorted-global order, halo
    excluded) exactly as ``Dmat.local_view_owned`` stores it."""
    if not dmap.inmap(pid):
        return None
    owned = owned_indices_cached(dmap, tuple(int(s) for s in shape), pid)
    local_pos, file_pos = [], []
    for d, sf in enumerate(seg_falls):
        inter = falls_list_intersect(dmap.dim_falls(shape, d, pid), sf)
        gidx = falls_list_indices(inter)
        if gidx.size == 0:
            return None
        local_pos.append(_positions(owned[d], gidx, d, pid))
        file_pos.append(np.searchsorted(falls_list_indices(sf), gidx))
    return tuple(local_pos), tuple(file_pos)


def as_basic_index(pos_tuple: tuple[np.ndarray, ...]):
    """Per-dim position arrays -> an ndarray index for one read/write.

    Evenly-strided dims lower to ``slice`` objects (on an
    ``np.load(mmap_mode='r')`` array a slice read touches only the pages
    it covers); if any dim stays ragged, every dim is promoted to
    ``np.ix_`` outer-product form so mixed basic/advanced indexing
    semantics never apply.  Empty tuple (scalar leaf) indexes as
    ``arr[()]``."""
    sls: list = []
    ragged = False
    for p in pos_tuple:
        d = _lower_positions(np.asarray(p, dtype=np.int64))
        if d[0] == "slice":
            _, start, n, step = d
            sls.append(slice(start, start + (n - 1) * step + 1, step))
        else:
            sls.append(None)
            ragged = True
    if not ragged:
        return tuple(sls)
    return np.ix_(*[np.asarray(p, dtype=np.intp) for p in pos_tuple])


def _coalesce_enabled() -> bool:
    return os.environ.get("PPYTHON_REDIST_COALESCE", "1") not in (
        "0", "off", "no"
    )


def _thread_views_enabled() -> bool:
    """Opt-in zero-copy sends on by-reference transports
    (``PPYTHON_REDIST_THREAD_VIEWS=1``).

    When on, a ThreadComm rank posts a strided *view* of ``src.local``
    instead of a packed pin copy, and the receiver copies once, straight
    from the sender's memory into ``dst.local`` — per-block data
    movement drops from two traversals to one and the send allocates
    nothing.  The cost is the raw transport buffer contract: the sender
    must not mutate ``src.local`` in place until every peer has finished
    the redistribution (programs that rebuild arrays instead of mutating
    them — the FFT corner-turn loop — satisfy this trivially).  Off by
    default because the engine cannot police user mutations.
    """
    return os.environ.get("PPYTHON_REDIST_THREAD_VIEWS", "0") in (
        "1", "on", "yes"
    )


class _BoundSchedule:
    """A compiled plan *bound* to one concrete (src.local, dst.local)
    array pair: every strided view, staging buffer, and pack/unpack
    closure is prebuilt, so a steady-state iteration runs a handful of
    vectorized copies plus the transport calls — near-zero Python.

    Binding holds strong references to the two local arrays (the views
    alias them); identity is revalidated per execute, so rebinding
    happens only when a program redistributes between new arrays.
    """

    __slots__ = ("src_local", "dst_local", "by_ref", "views", "sends",
                 "local_fn", "recvs", "stat_deltas")

    def __init__(self, plan: "RedistPlan", comp: _CompiledPlan,
                 src_local: np.ndarray, dst_local: np.ndarray,
                 by_ref: bool, views: bool):
        self.src_local = src_local
        self.dst_local = dst_local
        self.by_ref = by_ref
        self.views = views
        stats = dict.fromkeys(_STAT_KEYS, 0)
        self.sends = []
        for xf in comp.sends:
            self.sends.append((xf.peer, self._make_pack(plan, xf, stats)))
            stats["messages"] += 1
            stats["bytes"] += xf.nelems * src_local.itemsize
        self.local_fn = (self._make_local(comp.local, stats)
                         if comp.local is not None else None)
        self.recvs = [self._make_recv(plan, xf, stats) for xf in comp.recvs]
        self.stat_deltas = {k: v for k, v in stats.items() if v}

    # -- send side -----------------------------------------------------------

    def _make_pack(self, plan, xf, stats):
        src = self.src_local
        if xf.descs is not None:
            view = xf.view(src)
            if not self.by_ref and view.flags["C_CONTIGUOUS"]:
                # serializing transports encode before isend returns, so
                # a contiguous view is a zero-copy buffer export
                payload = view.reshape(xf.block_shape)
                stats["sends_zero_copy"] += 1
                return lambda: payload
            if self.by_ref and self.views:
                # zero-copy view post (PPYTHON_REDIST_THREAD_VIEWS): the
                # receiver copies once, straight out of src.local; the
                # sender is held to the transport's no-mutate contract
                stats["sends_zero_copy"] += 1
                return lambda: view
            stats["sends_packed"] += 1
            stats["copies"] += 1
            if self.by_ref:
                # fresh pack per turn: the pack IS the pin that detaches
                # the posted payload from src.local (by-reference fabric)
                nelems, dtype = xf.nelems, src.dtype
                expanded, block = xf.expanded, xf.block_shape

                def pack():
                    buf = np.empty(nelems, dtype)
                    np.copyto(buf.reshape(expanded), view)
                    return buf.reshape(block)

                return pack
            stag = plan._staging_buf("s", xf.peer, xf.nelems, src.dtype)
            st_e = stag.reshape(xf.expanded)
            st_b = stag.reshape(xf.block_shape)

            def pack():
                np.copyto(st_e, view)
                return st_b

            return pack
        stats["sends_fancy"] += 1
        stats["copies"] += 1
        flat = src.reshape(-1)
        idx = xf.flat_idx
        if self.by_ref:
            nelems, dtype, block = xf.nelems, src.dtype, xf.block_shape

            def pack():
                buf = np.empty(nelems, dtype)
                np.take(flat, idx, out=buf)
                return buf.reshape(block)

            return pack
        stag = plan._staging_buf("s", xf.peer, xf.nelems, src.dtype)
        st_b = stag.reshape(xf.block_shape)

        def pack():
            np.take(flat, idx, out=stag)
            return st_b

        return pack

    # -- self-overlap --------------------------------------------------------

    def _make_local(self, pair, stats):
        s_xf, d_xf = pair
        src, dst = self.src_local, self.dst_local
        stats["copies"] += 1
        if s_xf.descs is not None and d_xf.descs is not None:
            views = _pair_views(src, s_xf.descs, dst, d_xf.descs)
            if views is not None:
                sv, dv = views
                return lambda: np.copyto(dv, sv, casting="unsafe")
        # ragged or refinement-incompatible: flat gather + flat scatter
        sflat, dflat = src.reshape(-1), dst.reshape(-1)
        s_idx = (s_xf.flat_idx if s_xf.flat_idx is not None
                 else _descs_flat_indices(s_xf, src.shape))
        d_idx = (d_xf.flat_idx if d_xf.flat_idx is not None
                 else _descs_flat_indices(d_xf, dst.shape))
        stats["copies"] += 1

        def local_fn():
            dflat[d_idx] = sflat[s_idx]

        return local_fn

    # -- receive side --------------------------------------------------------

    def _make_recv(self, plan, xf, stats):
        """(post, finish) pair: ``post(ctx, tag)`` returns the request,
        ``finish(payload)`` scatters (None when the payload lands
        directly inside dst.local)."""
        dst = self.dst_local
        peer = xf.peer
        if xf.descs is not None:
            dview = xf.view(dst)
            if (self.by_ref and self.views and xf.peer_descs is not None):
                # the payload is the sender's strided view over its own
                # src.local: re-stride both sides to their common refined
                # shape and move the block in ONE vectorized traversal,
                # src.local -> dst.local, no intermediate anywhere
                refine = _common_refinement(xf.peer_descs, xf.descs)
                if refine is not None:
                    dcommon = _refined_view(dview, xf.descs, refine, 1)
                    es_shape = _expanded_shape(xf.peer_descs)
                    expanded = xf.expanded
                    peer_descs = xf.peer_descs
                    cache: list = [None, None]  # [sender view, refined]

                    def finish(got, dv=dview, dc=dcommon):
                        if got.shape == es_shape:
                            if cache[0] is not got:
                                cache[0] = got
                                cache[1] = _refined_view(
                                    got, peer_descs, refine, 0)
                            np.copyto(dc, cache[1], casting="unsafe")
                        else:  # peer fell back to a contiguous pack
                            np.copyto(dv, got.reshape(expanded),
                                      casting="unsafe")

                    stats["recvs_direct"] += 1
                    stats["copies"] += 1
                    return (lambda ctx, tag: ctx.irecv(peer, tag), finish)
            if dview.flags["C_CONTIGUOUS"] and not (
                    self.by_ref and self.views):
                stats["recvs_direct"] += 1
                return (lambda ctx, tag: ctx.irecv_into(peer, tag, dview),
                        None)
            stats["recvs_staged"] += 1
            stats["copies"] += 1
            if self.by_ref:
                # the posted payload is the sender's private pack (or, in
                # views mode without a common refinement, its strided
                # view — reshape then materializes it in block order):
                # scatter straight from it, no staging hop
                expanded = xf.expanded

                def finish(got, dv=dview):
                    np.copyto(dv, got.reshape(expanded), casting="unsafe")

                return (lambda ctx, tag: ctx.irecv(peer, tag), finish)
            stag = plan._staging_buf("r", peer, xf.nelems, dst.dtype)
            st_e = stag.reshape(xf.expanded)

            def finish(got, dv=dview, st=st_e):
                np.copyto(dv, st)

            return (lambda ctx, tag: ctx.irecv_into(peer, tag, st_e),
                    finish)
        stats["recvs_fancy"] += 1
        stats["copies"] += 1
        dflat = dst.reshape(-1)
        idx = xf.flat_idx

        def finish(got, df=dflat, ix=idx):
            df[ix] = got.reshape(-1)

        if self.by_ref:
            return (lambda ctx, tag: ctx.irecv(peer, tag), finish)
        stag = plan._staging_buf("r", peer, xf.nelems, dst.dtype)
        st_b = stag.reshape(xf.block_shape)
        return (lambda ctx, tag: ctx.irecv_into(peer, tag, st_b), finish)

    # -- the steady-state turn ----------------------------------------------

    def run(self, ctx, tag) -> None:
        for peer, pack in self.sends:
            ctx.isend(peer, tag, pack())
        if self.local_fn is not None:
            self.local_fn()
        if self.recvs:
            pending = [(post(ctx, tag), finish) for post, finish in self.recvs]
            # complete in post order, blocking per request: transports
            # park receives on targeted per-key wakeups, so this skips
            # wait_all's poll/sleep sweep; unpacks are cheap vectorized
            # copies, so arrival-order draining buys nothing
            for req, finish in pending:
                got = req.wait()
                if finish is not None:
                    finish(got)
        _exec_add(**self.stat_deltas)


def _descs_flat_indices(xf: _Xfer, local_shape) -> np.ndarray:
    """Flat indices for an all-basic xfer (used when its partner side of
    a self-copy is ragged and the pair must go through flat indexing)."""
    pos = []
    for d in xf.descs:
        if d[0] == "slice":
            _, start, count, step = d
            pos.append(np.arange(start, start + count * step, step,
                                 dtype=np.int64))
        else:
            _, start, n, L, stride = d
            seg = np.arange(L, dtype=np.int64)
            pos.append((start + np.arange(n, dtype=np.int64)[:, None]
                        * stride + seg[None, :]).reshape(-1))
    return _flat_indices(tuple(pos), local_shape)


@dataclass
class RedistPlan:
    """One rank's complete communication schedule for a redistribution.

    ``sends``/``recvs`` pair a peer rank with the per-dim *local* positions
    of the block exchanged (source positions when sending, destination
    positions when receiving); ``local_copy`` is the self-overlap.  The
    plan is pure index data — executing it does no PITFALLS math.

    The compiled execution schedule (slice lowering, flat index sets) and
    the persistent per-peer staging buffers are built lazily on first
    execute and live with the plan, so every cached steady-state
    iteration reuses them.
    """

    tag: tuple
    ndim: int
    sends: list[tuple[int, tuple[np.ndarray, ...]]] = field(default_factory=list)
    recvs: list[tuple[int, tuple[np.ndarray, ...]]] = field(default_factory=list)
    local_copy: tuple[tuple[np.ndarray, ...], tuple[np.ndarray, ...]] | None = None
    # sender-side local positions per recv entry (aligned with ``recvs``):
    # what the payload aliases when the zero-copy view path is active
    recv_src_pos: list = field(default_factory=list)
    _compiled: Any = field(default=None, repr=False, compare=False)
    _staging: dict = field(default_factory=dict, repr=False, compare=False)
    _bound: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def msg_count(self) -> int:
        return len(self.sends) + len(self.recvs)

    # -- compiled (v3) execution ---------------------------------------------

    def _compile(self, src_shape, dst_shape) -> _CompiledPlan:
        comp = self._compiled
        if (comp is None or comp.src_shape != src_shape
                or comp.dst_shape != dst_shape):
            with _trace.span("redist.compile", msgs=self.msg_count):
                comp = _CompiledPlan(self, src_shape, dst_shape)
            self._compiled = comp
        return comp

    def _staging_buf(self, role: str, peer: int, nelems: int,
                     dtype) -> np.ndarray:
        """Persistent flat staging buffer for one (direction, peer)."""
        key = (role, peer, dtype.str)
        buf = self._staging.get(key)
        if buf is None or buf.size != nelems:
            buf = np.empty(nelems, dtype=dtype)
            self._staging[key] = buf
        return buf

    def _bind(self, src_local: np.ndarray, dst_local: np.ndarray,
              by_ref: bool, views: bool) -> _BoundSchedule:
        """Fetch (or build) the schedule bound to this array pair.

        Steady-state loops redistribute between the same two Dmats, so
        the single-entry-per-pair cache hits every iteration and the
        prebuilt views/closures are reused; a program cycling through
        many array pairs under one plan keeps a small bounded set."""
        key = (id(src_local), id(dst_local), by_ref, views)
        bound = self._bound.get(key)
        if (bound is not None and bound.src_local is src_local
                and bound.dst_local is dst_local):
            return bound
        comp = self._compile(src_local.shape, dst_local.shape)
        bound = _BoundSchedule(self, comp, src_local, dst_local, by_ref,
                               views)
        # Bindings hold strong references to the two local arrays (their
        # views alias them), so a cached plan pins its most recent array
        # pairs until rebinding, eviction, or clear_plan_cache().  The
        # cap keeps that retention to a few pairs per plan.
        if len(self._bound) >= 4:  # bounded: drop the oldest binding
            self._bound.pop(next(iter(self._bound)))
        self._bound[key] = bound
        return bound

    def execute(self, dst, src, coalesce: bool | None = None) -> None:
        """Move the data: post all sends, self-copy, then complete the
        receives.  All sends are posted before any receive (one-sided
        transports), so no ordering can deadlock.

        Exactly one message is posted per communicating peer pair.  Per
        peer, the bound schedule picks the cheapest mechanism the index
        structure allows: a zero-copy contiguous view, a strided view
        packed into plan-owned staging, or a flat-index pack for ragged
        sets.  Receives with basic structure land through
        ``irecv_into`` — contiguous destination regions take the payload
        bytes directly inside ``dst.local``.
        """
        if coalesce is None:
            coalesce = _coalesce_enabled()
        if (not coalesce
                or not src.local.flags["C_CONTIGUOUS"]
                or not dst.local.flags["C_CONTIGUOUS"]):
            # the compiled index arithmetic assumes C-contiguous locals
            # (always true for Dmat-allocated buffers); anything exotic
            # takes the general fancy-index path
            with _trace.span("redist.execute", msgs=self.msg_count,
                             path="naive"):
                return self.execute_naive(dst, src)
        ctx = dst.ctx
        by_ref = bool(getattr(ctx, "payload_by_reference", False))
        views = by_ref and _thread_views_enabled()
        with _trace.span("redist.execute", msgs=self.msg_count,
                         path="compiled"):
            self._bind(src.local, dst.local, by_ref, views).run(ctx, self.tag)

    # -- naive (v2) execution --------------------------------------------------

    def execute_naive(self, dst, src) -> None:
        """The engine-v2 data path: per-peer ``np.ix_`` fancy gather on
        send, buffer-allocating receive + fancy scatter.  Kept as the
        correctness baseline (`PPYTHON_REDIST_COALESCE=0`) and the
        benchmark comparison point."""
        ctx = dst.ctx
        sent_bytes = 0
        copies = 0
        for peer, src_pos in self.sends:
            block = src.local[np.ix_(*src_pos)]
            sent_bytes += block.nbytes
            copies += 1
            ctx.isend(peer, self.tag, block)
        if self.local_copy is not None:
            src_pos, dst_pos = self.local_copy
            dst.local[np.ix_(*dst_pos)] = src.local[np.ix_(*src_pos)]
            copies += 1
        if self.recvs:
            reqs = [ctx.irecv(peer, self.tag) for peer, _ in self.recvs]
            blocks = ctx.wait_all(reqs)
            for (peer, dst_pos), block in zip(self.recvs, blocks):
                # reshape: a coalesced peer in zero-copy view mode posts
                # the block in its own expanded factorization
                block_shape = tuple(len(p) for p in dst_pos)
                dst.local[np.ix_(*dst_pos)] = block.reshape(block_shape)
                copies += 1
        _exec_add(
            messages=len(self.sends), bytes=sent_bytes, copies=copies,
            naive_executions=1,
        )


def build_plan(
    src_dmap: Dmap,
    src_shape: tuple[int, ...],
    dst_dmap: Dmap,
    dst_shape: tuple[int, ...],
    region: tuple[tuple[int, int], ...],
    me: int,
) -> RedistPlan:
    """Compute rank ``me``'s schedule from scratch (the cold path).

    For every (sender, receiver) pair, the per-dim PITFALLS intersection
    of the sender's ownership (shifted into the destination window) with
    the receiver's ownership (clipped to the window) yields exactly the
    global indices the pair exchanges; a pair moves data only when every
    dimension's set is non-empty (the exchanged block is the cross
    product).
    """
    ndim = len(dst_shape)
    offsets = tuple(start for start, _ in region)
    plan = RedistPlan(
        tag=("__rd", _stable_tag(src_dmap, dst_dmap, src_shape, dst_shape, region)),
        ndim=ndim,
    )

    def pair_indices(s_rank: int, d_rank: int):
        """Per-dim global dst-space indices exchanged by (s_rank, d_rank)."""
        out = []
        for d in range(ndim):
            src_falls = src_dmap.dim_falls(src_shape, d, s_rank)
            off = offsets[d]
            shifted = [
                type(f)(f.l + off, f.r + off, f.s, f.n) for f in src_falls
            ]
            dst_falls = dst_dmap.dim_falls(dst_shape, d, d_rank)
            lo, hi = region[d]
            hit = falls_list_intersect(shifted, dst_falls)
            idx = falls_list_indices(hit)
            idx = idx[(idx >= lo) & (idx < hi)]
            if len(idx) == 0:
                return None
            out.append(idx)
        return out

    local_src_pos: tuple[np.ndarray, ...] | None = None
    if src_dmap.inmap(me):
        src_owned = owned_indices_cached(src_dmap, src_shape, me)
        for d_rank in dst_dmap.proclist:
            idx = pair_indices(me, d_rank)
            if idx is None:
                continue
            src_pos = tuple(
                _positions(src_owned[d], g - offsets[d], d, me)
                for d, g in enumerate(idx)
            )
            if d_rank == me:
                local_src_pos = src_pos
            else:
                plan.sends.append((d_rank, src_pos))

    if dst_dmap.inmap(me):
        dst_owned = owned_indices_cached(dst_dmap, dst_shape, me)
        for s_rank in src_dmap.proclist:
            idx = pair_indices(s_rank, me)
            if idx is None:
                continue
            dst_pos = tuple(
                _positions(dst_owned[d], g, d, me) for d, g in enumerate(idx)
            )
            if s_rank == me:
                plan.local_copy = (local_src_pos, dst_pos)
            else:
                plan.recvs.append((s_rank, dst_pos))
                # the sender's local positions of the same block, for the
                # by-reference zero-copy view receive path; computed here
                # on the cold path (plans are cached) and sharing the
                # global owned-index cache, so the serializing
                # transports — which never take that path — pay only a
                # searchsorted per peer per cold build
                peer_owned = owned_indices_cached(src_dmap, src_shape, s_rank)
                plan.recv_src_pos.append(tuple(
                    _positions(peer_owned[d], g - offsets[d], d, s_rank)
                    for d, g in enumerate(idx)
                ))

    return plan


def _cache_enabled() -> bool:
    return os.environ.get("PPYTHON_REDIST_CACHE", "1") not in ("0", "off", "no")


def get_plan(
    src_dmap: Dmap,
    src_shape: tuple[int, ...],
    dst_dmap: Dmap,
    dst_shape: tuple[int, ...],
    region: tuple[tuple[int, int], ...],
    me: int,
    use_cache: bool | None = None,
) -> RedistPlan:
    """Fetch (or build and memoize) rank ``me``'s plan for this key."""
    src_shape = tuple(int(s) for s in src_shape)
    dst_shape = tuple(int(s) for s in dst_shape)
    region = tuple((int(a), int(b)) for a, b in region)
    if use_cache is None:
        use_cache = _cache_enabled()
    if not use_cache:
        with _trace.span("redist.plan_build", cache="off"):
            return build_plan(src_dmap, src_shape, dst_dmap, dst_shape,
                              region, me)
    key = (src_dmap, src_shape, dst_dmap, dst_shape, region, me)
    plan = _plan_cache.get(key)
    if plan is None:
        with _trace.span("redist.plan_build", cache="miss"):
            plan = build_plan(src_dmap, src_shape, dst_dmap, dst_shape,
                              region, me)
        _plan_cache.put(key, plan)
    return plan


def plan_cache_stats() -> dict[str, Any]:
    """Plan-cache hit/miss counters plus the execution engine's
    message/byte/copy counters (benchmark + test hook)."""
    hits, misses = _plan_cache.hits, _plan_cache.misses
    total = hits + misses
    out = {
        "hits": hits,
        "misses": misses,
        "entries": len(_plan_cache),
        "hit_rate": (hits / total) if total else 0.0,
    }
    out.update(exec_stats())
    return out


def clear_plan_cache() -> None:
    _plan_cache.clear()
    for c in _EXEC.values():
        c.reset()


# ---------------------------------------------------------------------------
# The communication operator
# ---------------------------------------------------------------------------


def redistribute(dst, src, region=None, use_cache: bool | None = None,
                 coalesce: bool | None = None) -> None:
    """``dst[region] = src``: general block-cyclic redistribution.

    ``region`` is the per-dim half-open target window in dst's global
    index space (defaults to the whole array); ``src`` global index ``g``
    lands at dst index ``g + region_start`` per dim.  The schedule comes
    from the plan cache; execution is pure data movement — one coalesced
    message per communicating peer pair through the compiled fast paths
    (``coalesce=False`` or ``PPYTHON_REDIST_COALESCE=0`` selects the
    naive v2 gather/scatter executor instead).
    """
    if region is None:
        region = [(0, n) for n in src.shape]
    region = tuple((int(a), int(b)) for a, b in region)
    rshape = tuple(stop - start for start, stop in region)
    if rshape != src.shape:
        raise ValueError(
            f"target region shape {rshape} != source shape {src.shape}"
        )
    if len(src.shape) != len(dst.shape):
        raise ValueError("rank mismatch in redistribution")
    plan = get_plan(
        src.dmap, src.shape, dst.dmap, dst.shape, region,
        dst.ctx.pid, use_cache=use_cache,
    )
    plan.execute(dst, src, coalesce=coalesce)
