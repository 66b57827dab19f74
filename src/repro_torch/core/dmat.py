"""``Dmat`` — pPython's distributed numerical array (paper §II, §III).

Each SPMD rank holds only its *local part* (owned indices + overlap halo),
laid out in sorted-global-index order per dimension.  The communication
operator is subscripted assignment: ``Z[:, :] = X`` redistributes between
any two block/cyclic/block-cyclic(-overlapped) maps, with the message
schedule computed by PITFALLS and executed over the active PythonMPI
context.

Fragmented-PGAS surface (paper §II.C): constructors, index support
functions, element-wise arithmetic — and deliberately not a full
distributed NumPy.  Everything also works with maps "turned off" (plain
ndarrays) so a program can be debugged serially.

The port's own copy of ``repro.core.dmat`` (NumPy only), for the checkpoint's
``Dmat`` paths; it differs from the original in its docstrings alone.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..comm import get_context
from ..comm.collectives import group_of
from ..comm.context import CommContext
from .dmap import Dmap
from .redist import halo_extents_cached, owned_indices_cached, redistribute

__all__ = ["Dmat", "redistribute"]


class Dmat:
    """Distributed array: global ``shape``/``dtype`` + per-rank local part."""

    __array_priority__ = 100  # win ufunc dispatch over ndarray

    def __init__(
        self,
        shape: Sequence[int],
        dmap: Dmap,
        dtype=np.float64,
        ctx: CommContext | None = None,
        _alloc: bool = True,
    ):
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) != dmap.ndim:
            raise ValueError(
                f"array rank {len(self.shape)} != map rank {dmap.ndim}"
            )
        self.dmap = dmap
        self.dtype = np.dtype(dtype)
        self.ctx = ctx if ctx is not None else get_context()
        # owned-index arrays are computed lazily: element-wise ops build
        # result Dmats constantly and must not pay O(n) index bookkeeping
        # per op (the paper's §V "inefficient array indexing" lesson)
        self.__owned: list[np.ndarray] | None = None
        self.__halo: list[int] | None = None
        self.local = (
            np.zeros(self.local_shape_with_halo(), dtype=self.dtype)
            if _alloc
            else None
        )

    def _index_cache(self):
        if self.__owned is None:
            # shared per-(map, shape, rank) cache: every Dmat built under
            # the same map reuses one set of index arrays (see redist.py)
            pid = self.ctx.pid
            self.__owned = list(owned_indices_cached(self.dmap, self.shape, pid))
            self.__halo = list(halo_extents_cached(self.dmap, self.shape, pid))
        return self.__owned, self.__halo

    @property
    def _owned(self) -> list:
        return self._index_cache()[0]

    @property
    def _halo(self) -> list:
        return self._index_cache()[1]

    def local_shape_with_halo(self) -> tuple[int, ...]:
        owned, halo = self._index_cache()
        return tuple(len(ix) + h for ix, h in zip(owned, halo))

    # -- basic introspection ---------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def pid(self) -> int:
        return self.ctx.pid

    def owned_indices(self, dim: int) -> np.ndarray:
        """Sorted owned global indices along ``dim`` for this rank."""
        return self._owned[dim]

    def local_view_owned(self) -> np.ndarray:
        """Local buffer with halo stripped (the owned region)."""
        slc = tuple(
            slice(0, len(ix)) for ix in self._owned
        )
        return self.local[slc]

    def global_block_range(self, dim: int, pid: int | None = None) -> tuple[int, int]:
        return self.dmap.global_block_range(
            self.shape, dim, self.pid if pid is None else pid
        )

    def global_block_ranges(self, dim: int) -> list[tuple[int, int, int]]:
        """(pid, start, stop) for every rank of the map along ``dim``."""
        return [
            (p, *self.dmap.global_block_range(self.shape, dim, p))
            for p in self.dmap.proclist
        ]

    # -- global <-> local index maps --------------------------------------------

    def _local_positions(self, dim: int, global_idx: np.ndarray) -> np.ndarray:
        """Local storage positions of (owned) global indices along ``dim``."""
        owned = self._owned[dim]
        pos = np.searchsorted(owned, global_idx)
        if np.any(pos >= len(owned)) or np.any(owned[pos] != global_idx):
            raise IndexError(
                f"global indices not owned by rank {self.pid} along dim {dim}"
            )
        return pos

    # -- element-wise arithmetic (fragmented PGAS) -------------------------------

    def _binary(self, other, op, reflected: bool = False) -> "Dmat":
        out = Dmat(self.shape, self.dmap, dtype=None, ctx=self.ctx, _alloc=False)
        if isinstance(other, Dmat):
            if other.dmap != self.dmap or other.shape != self.shape:
                raise ValueError(
                    "element-wise ops require identical maps (fragmented PGAS); "
                    "redistribute first with A[:, :] = B"
                )
            rhs = other.local
        elif np.isscalar(other) or isinstance(other, np.ndarray):
            rhs = other
        else:
            return NotImplemented
        out.local = op(rhs, self.local) if reflected else op(self.local, rhs)
        out.dtype = out.local.dtype
        return out

    def __add__(self, o):  # noqa: D105
        return self._binary(o, np.add)

    def __radd__(self, o):
        return self._binary(o, np.add, reflected=True)

    def __sub__(self, o):
        return self._binary(o, np.subtract)

    def __rsub__(self, o):
        return self._binary(o, np.subtract, reflected=True)

    def __mul__(self, o):
        return self._binary(o, np.multiply)

    def __rmul__(self, o):
        return self._binary(o, np.multiply, reflected=True)

    def __truediv__(self, o):
        return self._binary(o, np.divide)

    def __rtruediv__(self, o):
        return self._binary(o, np.divide, reflected=True)

    def __pow__(self, o):
        return self._binary(o, np.power)

    def __neg__(self):
        out = Dmat(self.shape, self.dmap, dtype=self.dtype, ctx=self.ctx, _alloc=False)
        out.local = -self.local
        return out

    def __abs__(self):
        out = Dmat(self.shape, self.dmap, dtype=self.dtype, ctx=self.ctx, _alloc=False)
        out.local = np.abs(self.local)
        out.dtype = out.local.dtype
        return out

    # -- global reductions ---------------------------------------------------------

    def _allreduce(self, local_val, op, identity=None, name: str = "reduce") -> Any:
        """True allreduce over the map's group (recursive doubling / ring
        via ``comm.collectives``), then a bridge broadcast to any world
        ranks outside the proclist — every rank must call (SPMD), every
        rank gets the result.  Tags are counter-derived per (group, op),
        so interleaved reductions on one context can never cross-match
        streams (the old fixed ``"__pp_red"`` tag could).

        Ranks with empty local parts contribute ``None``; the collectives
        combine step skips them."""
        ctx = self.ctx
        members = self.dmap.proclist
        member_set = set(members)
        out = None
        if ctx.pid in member_set:
            out = group_of(ctx, members).allreduce(local_val, op)
        outsiders = tuple(p for p in range(ctx.np_) if p not in member_set)
        if outsiders:
            lead = members[0]
            bridge = group_of(ctx, (lead,) + outsiders)
            if bridge.rank is not None:
                out = bridge.bcast(out if ctx.pid == lead else None, root=lead)
        if out is None:
            # zero-size global array: sum has an identity, max/min do not
            if identity is not None:
                return identity
            raise ValueError(
                f"zero-size Dmat reduction '{name}' has no identity "
                f"(shape {self.shape})"
            )
        return out

    def sum(self):
        own = self.local_view_owned()
        loc = own.sum() if own.size else None
        return self._allreduce(
            loc, lambda a, b: a + b, identity=self.dtype.type(0), name="sum"
        )

    def max(self):
        own = self.local_view_owned()
        loc = own.max() if own.size else None
        return self._allreduce(loc, max, name="max")

    def min(self):
        own = self.local_view_owned()
        loc = own.min() if own.size else None
        return self._allreduce(loc, min, name="min")

    # -- subscripted assignment: THE communication operator ------------------------

    def __setitem__(self, key, value) -> None:
        region = _parse_region(key, self.shape)
        if isinstance(value, Dmat):
            redistribute(self, value, region)
        elif np.isscalar(value):
            self._fill_region(region, value)
        elif isinstance(value, np.ndarray):
            self._assign_global_array(region, value)
        else:
            raise TypeError(f"cannot assign {type(value)} to Dmat")

    def _region_local(self, region):
        """Per-dim (local slice, global indices) of owned ∩ region.

        Owned indices are stored sorted, so the local positions covering
        a contiguous global window are always a contiguous ``arange`` —
        returned as a basic *slice* so consumers index the local buffer
        with views instead of fancy-index temporaries.
        """
        slices, gidx = [], []
        for d, (start, stop) in enumerate(region):
            owned = self._owned[d]
            lo = int(np.searchsorted(owned, start))
            hi = int(np.searchsorted(owned, stop))
            slices.append(slice(lo, hi))
            gidx.append(owned[lo:hi])
        return slices, gidx

    def _fill_region(self, region, scalar) -> None:
        slices, _ = self._region_local(region)
        if all(s.stop > s.start for s in slices):
            self.local[tuple(slices)] = scalar

    def _assign_global_array(self, region, arr: np.ndarray) -> None:
        rshape = tuple(stop - start for start, stop in region)
        if arr.shape != rshape:
            raise ValueError(f"value shape {arr.shape} != region shape {rshape}")
        slices, gidx = self._region_local(region)
        if all(s.stop > s.start for s in slices):
            take = np.ix_(*[g - start for g, (start, _) in zip(gidx, region)])
            self.local[tuple(slices)] = arr[take]

    def __getitem__(self, key):
        region = _parse_region(key, self.shape)
        slices, gidx = self._region_local(region)
        rshape = tuple(stop - start for start, stop in region)
        covered = all(
            len(g) == (stop - start)
            for g, (start, stop) in zip(gidx, region)
        )
        if not covered:
            raise IndexError(
                "region not fully local to this rank; use local(A) for the "
                "local part or agg(A) to gather the global array"
            )
        # copy: subscript reads hand out private data, never local views
        out = self.local[tuple(slices)].reshape(rshape).copy()
        return out[()] if out.ndim == 0 else out

    # -- misc ---------------------------------------------------------------------

    def astype(self, dtype) -> "Dmat":
        out = Dmat(self.shape, self.dmap, dtype=dtype, ctx=self.ctx, _alloc=False)
        out.local = self.local.astype(dtype)
        return out

    def copy(self) -> "Dmat":
        out = Dmat(self.shape, self.dmap, dtype=self.dtype, ctx=self.ctx, _alloc=False)
        out.local = self.local.copy()
        return out

    def __repr__(self) -> str:
        return (
            f"Dmat(shape={self.shape}, dtype={self.dtype}, pid={self.pid}, "
            f"local={self.local.shape}, map={self.dmap})"
        )


def _parse_region(key, shape) -> list[tuple[int, int]]:
    """Normalize a subscript into per-dim half-open global ranges."""
    if not isinstance(key, tuple):
        key = (key,)
    if len(key) != len(shape):
        raise IndexError(
            f"subscript must index all {len(shape)} dims (got {len(key)}); "
            "pPython subsasgn is region-based"
        )
    region = []
    for k, n in zip(key, shape):
        if isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step != 1:
                raise IndexError("strided subscripts are not supported")
            region.append((start, stop))
        elif isinstance(k, (int, np.integer)):
            k = int(k) % n
            region.append((k, k + 1))
        else:
            raise IndexError(f"unsupported subscript component {k!r}")
    return region


# -----------------------------------------------------------------------------
# Redistribution now lives in redist.py (plan-cached, isend/irecv-executed);
# ``redistribute`` is re-exported above for the paper-facing API surface.
# -----------------------------------------------------------------------------
