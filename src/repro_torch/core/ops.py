"""pPython array constructors and parallel support functions.

Paper §II.A: constructors take ``map=``; when it is not a ``Dmap`` they
return a plain NumPy array — the "maps off" switch that turns a parallel
program back into a serial one for debugging.

Paper §III.E support functions: ``global_block_range``, ``agg``,
``global_block_ranges``, ``grid``, ``inmap``, ``local``, ``put_local``,
``synch`` — all of which also accept plain ndarrays so code keeps working
with maps off.

The port's own copy of ``repro.core.ops`` (NumPy only), for the checkpoint's
``Dmat`` paths; it differs from the original in its docstrings alone.
"""

from __future__ import annotations

import numpy as np

from ..comm import get_context
from ..comm.context import ctx_counter as _ctx_counter
from .dmap import Dmap
from .dmat import Dmat
from .redist import _lower_dims, _strided_view, owned_indices_cached

__all__ = [
    "zeros",
    "ones",
    "rand",
    "randn",
    "arange_field",
    "dcomplex",
    "sprand",
    "fft",
    "local",
    "put_local",
    "agg",
    "agg_all",
    "scatter",
    "global_block_range",
    "global_block_ranges",
    "global_ind",
    "grid",
    "inmap",
    "synch",
    "barrier",
    "transpose_grid",
]


def _is_map(m) -> bool:
    return isinstance(m, Dmap)


def _construct(shape, map, dtype, fill) -> Dmat | np.ndarray:
    if not _is_map(map):
        # maps off -> serial NumPy (paper §II.A)
        return fill(shape, dtype)
    a = Dmat(shape, map, dtype=dtype)
    a.local = fill(a.local.shape, dtype)
    return a


def zeros(*shape, map=None, dtype=np.float64):
    shape = _norm_shape(shape)
    return _construct(shape, map, dtype, lambda s, d: np.zeros(s, dtype=d))


def ones(*shape, map=None, dtype=np.float64):
    shape = _norm_shape(shape)
    return _construct(shape, map, dtype, lambda s, d: np.ones(s, dtype=d))


def rand(*shape, map=None, dtype=np.float64, seed: int | None = None):
    """Uniform [0,1).  Paper §IV.B: unlike pMatlab, each pPython process
    draws *different* random numbers by default; pass ``seed`` for
    per-rank-deterministic streams (rank folded into the seed)."""
    shape = _norm_shape(shape)

    def fill(s, d):
        if seed is None:
            rng = np.random.default_rng()
        else:
            pid = get_context().pid if _is_map(map) else 0
            rng = np.random.default_rng((seed, pid))
        return rng.random(s).astype(d)

    return _construct(shape, map, dtype, fill)


def randn(*shape, map=None, dtype=np.float64, seed: int | None = None):
    shape = _norm_shape(shape)

    def fill(s, d):
        if seed is None:
            rng = np.random.default_rng()
        else:
            pid = get_context().pid if _is_map(map) else 0
            rng = np.random.default_rng((seed, pid))
        return rng.standard_normal(s).astype(d)

    return _construct(shape, map, dtype, fill)


def arange_field(*shape, map=None, dtype=np.float64):
    """Array whose value at global index (i,j,..) encodes that index
    (row-major linear id).  The workhorse oracle for redistribution tests:
    after any sequence of redistributions the value must still equal the
    linear id of its global position."""
    shape = _norm_shape(shape)
    if not _is_map(map):
        return np.arange(np.prod(shape), dtype=dtype).reshape(shape)
    a = Dmat(shape, map, dtype=dtype)
    if a.local.size:
        grids = np.meshgrid(
            *[_ext_indices(a, d) for d in range(a.ndim)], indexing="ij"
        )
        lin = np.zeros_like(grids[0])
        for d, g in enumerate(grids):
            lin = lin * shape[d] + g
        a.local[...] = lin.astype(dtype)
    return a


def _ext_indices(a: Dmat, d: int) -> np.ndarray:
    """Owned + halo global indices along dim d (halo extends past owned)."""
    owned = a.owned_indices(d)
    h = a._halo[d]
    if h == 0:
        return owned
    ext = np.arange(owned[-1] + 1, owned[-1] + 1 + h, dtype=np.int64)
    return np.concatenate([owned, ext])


def dcomplex(re, im):
    """Complex array from real/imag parts (paper's FFT example)."""
    if isinstance(re, Dmat):
        if not isinstance(im, Dmat) or im.dmap != re.dmap:
            raise ValueError("dcomplex parts must share one map")
        out = Dmat(re.shape, re.dmap, dtype=np.complex128, ctx=re.ctx, _alloc=False)
        out.local = re.local + 1j * im.local
        return out
    return np.asarray(re) + 1j * np.asarray(im)


def sprand(*shape, density=0.01, map=None, seed: int | None = None):
    """Distributed sparse (CSR local parts).  Paper §III: pPython supports
    distributed sparse matrices; kept minimal — construction + todense."""
    import scipy.sparse as sp

    shape = _norm_shape(shape)
    if not _is_map(map):
        rng = np.random.default_rng(seed)
        return sp.random(*shape, density=density, random_state=rng, format="csr")
    a = Dmat(shape, map, dtype=np.float64)
    rng = np.random.default_rng(None if seed is None else (seed, a.pid))
    lshape = a.local.shape
    a.local = None
    a.sparse_local = (
        sp.random(*lshape, density=density, random_state=rng, format="csr")
        if len(lshape) == 2
        else None
    )
    if a.sparse_local is None:
        raise ValueError("sprand supports 2-D maps only")
    a.local = np.zeros(lshape)  # dense shadow for the Dmat machinery
    a.local[...] = a.sparse_local.toarray()
    return a


def fft(a, n: int | None = None, axis: int = -1):
    """FFT along a *local* (undistributed) axis — the paper's FFT pattern:
    FFT rows, redistribute, FFT columns."""
    if isinstance(a, Dmat):
        axis = axis % a.ndim
        if a.dmap.grid[axis] != 1:
            raise ValueError(
                f"fft axis {axis} is distributed; redistribute first "
                "(Z[:, :] = X) so the transform axis is local"
            )
        out = Dmat(a.shape, a.dmap, dtype=np.complex128, ctx=a.ctx, _alloc=False)
        out.local = np.fft.fft(a.local, n=n, axis=axis)
        return out
    return np.fft.fft(a, n=n, axis=axis)


# ---------------------------------------------------------------------------
# Parallel support functions (paper §III.E) — all work with maps off too
# ---------------------------------------------------------------------------


def local(a):
    """The local part of ``a`` (identity for plain arrays)."""
    return a.local if isinstance(a, Dmat) else a


def put_local(a, x) -> None:
    """Replace the local part of ``a`` (shape must match, halo included)."""
    if isinstance(a, Dmat):
        x = np.asarray(x, dtype=a.dtype)
        if x.shape != a.local.shape:
            raise ValueError(f"local shape {a.local.shape} != value {x.shape}")
        a.local = x
    else:
        a[...] = x


def agg(a, root: int | None = None):
    """Gather the global array onto the leader (root defaults to the first
    processor of the map).  Returns the assembled ndarray on the leader and
    ``None`` elsewhere; identity for plain ndarrays.

    The root derives every sender's owned-index set locally (the shared
    redistribution cache), lowers it to slice/segment descriptors, and
    posts ``irecv_into`` on strided views of the output — regular blocks
    land straight in the assembled array with no index lists on the wire
    and no per-block temporaries; ragged (non-sliceable) owners fall back
    to ``np.ix_`` assignment.  Only ranks holding data send (one
    ``isend`` each); receives complete in arrival order, so one slow
    rank never serializes the assembly of the others."""
    if not isinstance(a, Dmat):
        return a
    ctx = a.ctx
    root = a.dmap.proclist[0] if root is None else root
    me = ctx.pid
    tag = ("__pp_agg", _ctx_counter(ctx, "agg"))

    def owned(pid):
        idx = owned_indices_cached(a.dmap, a.shape, pid)
        return idx if all(len(i) for i in idx) else None

    if me != root:
        if a.dmap.inmap(me) and owned(me) is not None:
            # the copy pins the payload (ThreadComm hands arrays by
            # reference and the sender may mutate its local part before
            # the root drains) AND makes it contiguous, so serializing
            # transports export the block bytes without a pack step
            ctx.isend(root, tag, a.local_view_owned().copy())
        return None
    out = np.zeros(a.shape, dtype=a.dtype)
    if a.dmap.inmap(me):
        idx = owned(me)
        if idx is not None:
            descs = _lower_dims(idx)
            if descs is not None:
                view = _strided_view(out, descs)
                np.copyto(view, a.local_view_owned().reshape(view.shape))
            else:
                out[np.ix_(*idx)] = a.local_view_owned()
    reqs = []
    for p in a.dmap.proclist:
        if p == root:
            continue
        idx = owned(p)
        if idx is None:
            continue  # nothing owned: that rank did not send
        descs = _lower_dims(idx)
        if descs is not None:
            # regular block: land the payload bytes straight into the
            # output's strided window (land_into reshapes by element
            # count, so the sender's owned shape maps onto the view)
            reqs.append((ctx.irecv_into(p, tag, _strided_view(out, descs)),
                         None))
        else:
            reqs.append((ctx.irecv(p, tag), idx))
    done = ctx.wait_all([r for r, _ in reqs])
    for (_, idx), block in zip(reqs, done):
        if idx is not None:
            out[np.ix_(*idx)] = block.reshape([len(i) for i in idx])
    return out


def agg_all(a):
    """Gather the global array onto *every* rank: arrival-order ``agg``
    to the map leader, then a topology-aware broadcast (binomial tree for
    eager payloads, chunked ring for long arrays, one payload file on
    FileMPI — see ``comm.collectives``)."""
    if not isinstance(a, Dmat):
        return a
    root = a.dmap.proclist[0]
    full = agg(a, root=root)
    from ..comm.collectives import world_group

    return world_group(a.ctx).bcast(full, root=root)


def scatter(global_arr: np.ndarray, dmap: Dmap, dtype=None) -> Dmat:
    """Build a Dmat from a replicated global ndarray (each rank slices its
    own part locally — no communication).

    Regular (slice/segment) owned+halo index sets copy through a strided
    view of the global array — one vectorized ``copyto``, no ``np.ix_``
    index cross product or gather temporary; ragged sets keep the fancy
    path."""
    a = Dmat(
        global_arr.shape,
        dmap,
        dtype=global_arr.dtype if dtype is None else dtype,
    )
    if a.local.size:
        idx = tuple(_ext_indices(a, d) for d in range(a.ndim))
        src = np.asarray(global_arr)
        descs = _lower_dims(idx) if src.flags["C_CONTIGUOUS"] else None
        if descs is not None:
            view = _strided_view(src, descs)
            np.copyto(a.local.reshape(view.shape), view, casting="unsafe")
        else:
            a.local[...] = global_arr[np.ix_(*idx)]
    return a


def global_block_range(a: Dmat, dim: int, pid: int | None = None):
    if not isinstance(a, Dmat):
        return (0, np.asarray(a).shape[dim])
    return a.global_block_range(dim, pid)


def global_block_ranges(a: Dmat, dim: int):
    if not isinstance(a, Dmat):
        return [(0, 0, np.asarray(a).shape[dim])]
    return a.global_block_ranges(dim)


def global_ind(a: Dmat, dim: int):
    """Owned global indices along ``dim`` (works for cyclic maps)."""
    if not isinstance(a, Dmat):
        return np.arange(np.asarray(a).shape[dim])
    return a.owned_indices(dim)


def grid(a):
    """The processor grid of ``a``'s map."""
    return a.dmap.grid if isinstance(a, Dmat) else (1,) * np.asarray(a).ndim


def inmap(m, pid: int | None = None) -> bool:
    if not isinstance(m, Dmap):
        return True
    return m.inmap(get_context().pid if pid is None else pid)


def barrier() -> None:
    get_context().barrier()


def synch(a) -> None:
    """Refresh overlap halos from the owning neighbors (paper §III.B).

    Halos extend toward higher indices: along each overlapped dim, the
    successor processor sends its first ``o`` owned slices, which land in
    the caller's halo.  All sends are posted non-blocking first, then all
    receives, completed in arrival order — deadlock free on every
    transport and never serialized on one slow neighbor."""
    if not isinstance(a, Dmat):
        return
    ctx = a.ctx
    me = ctx.pid
    if not a.dmap.inmap(me):
        return
    coords = a.dmap.grid_position(me)
    tag_base = ("__synch", _ctx_counter(ctx, "synch"))
    recvs = []
    for d in range(a.ndim):
        o = a.dmap.overlap[d]
        if o == 0 or a.dmap.grid[d] == 1:
            continue
        c = coords[d]
        owned_len = len(a.owned_indices(d))
        if c > 0 and owned_len:
            # ship my first min(o, owned) slices to my predecessor; the
            # copy pins the payload so later local mutation can't race the
            # neighbor's receive (ThreadComm hands arrays by reference)
            prev = list(coords)
            prev[d] = c - 1
            k = min(o, owned_len)
            sl = [slice(None)] * a.ndim
            sl[d] = slice(0, k)
            ctx.isend(a.dmap.pid_at(prev), (tag_base, d), a.local[tuple(sl)].copy())
        h = a._halo[d]
        if h > 0:
            nxt = list(coords)
            nxt[d] = c + 1
            sl = [slice(None)] * a.ndim
            sl[d] = slice(owned_len, owned_len + h)
            recvs.append((ctx.irecv(a.dmap.pid_at(nxt), (tag_base, d)), d, tuple(sl), h))
    blocks = ctx.wait_all([r for r, *_ in recvs])
    for (_, d, sl, h), block in zip(recvs, blocks):
        clip = [slice(None)] * a.ndim
        clip[d] = slice(0, h)
        a.local[sl] = block[tuple(clip)]


def transpose_grid(a: Dmat) -> Dmat:
    """Convenience: redistribute a 2-D Dmat to the transposed grid
    (row map <-> column map), the paper's FFT corner-turn.  ``Dmap`` is
    value-hashable, so the freshly built transposed map hits the same
    plan/index cache entries on every call."""
    if a.ndim != 2:
        raise ValueError("transpose_grid expects a 2-D Dmat")
    g = a.dmap.grid
    out_map = Dmap(
        [g[1], g[0]],
        list(a.dmap.dist[::-1]),
        a.dmap.proclist,
        order=a.dmap.order,
    )
    out = Dmat(a.shape, out_map, dtype=a.dtype, ctx=a.ctx)
    out[:, :] = a
    return out


def _norm_shape(shape) -> tuple[int, ...]:
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    return tuple(int(s) for s in shape)
