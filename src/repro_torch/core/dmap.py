"""``Dmap`` — the pPython map construct (paper Fig. 1, §III.B).

A map is (1) a grid describing how each dimension is partitioned, (2) a
distribution (block / cyclic / block-cyclic, per dimension), (3) a processor
list saying which ranks hold data, plus optional per-dimension overlap and a
processor-grid ``order`` ('row' = C-style, Python default; 'col' = Fortran
style, matching pMatlab).

The name is ``Dmap`` rather than ``map`` because Python reserves ``map``
(paper §II.A).  A Dmap carries no data: attaching it to an array constructor
(``zeros(..., map=m)``) yields a distributed ``Dmat``; passing anything that
is not a Dmap returns a plain NumPy array — the "maps off" debugging switch.

The port's own copy of ``repro.core.dmap`` (NumPy only): the checkpoint
reads a saved leaf's ``Dmap`` with it.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from .pitfalls import FALLS, dist_falls, falls_list_indices, falls_list_size, parse_dist

__all__ = ["Dmap"]

MAX_DIMS = 4  # paper: block-cyclic-overlapped redistribution in up to 4-D


def _normalize_dist(dist, ndim: int) -> tuple:
    """Expand the user spec into a per-dimension tuple of canonical specs."""
    if isinstance(dist, (list, tuple)):
        if len(dist) != ndim:
            raise ValueError(
                f"per-dimension distribution list has {len(dist)} entries "
                f"for a {ndim}-D grid"
            )
        return tuple(parse_dist(d) for d in dist)
    # single spec applied to every dimension (paper §III.B)
    return tuple(parse_dist(dist) for _ in range(ndim))


class Dmap:
    """Assignment of blocks of a (up to 4-D) array onto a processor grid."""

    def __init__(
        self,
        grid: Sequence[int],
        dist: dict | str | None | Sequence = None,
        proclist: Sequence[int] | range | None = None,
        overlap: Sequence[int] | None = None,
        order: str = "row",
    ):
        self.grid = tuple(int(g) for g in grid)
        if not self.grid or len(self.grid) > MAX_DIMS:
            raise ValueError(f"grid must have 1..{MAX_DIMS} dims, got {self.grid}")
        if any(g < 1 for g in self.grid):
            raise ValueError(f"grid entries must be >= 1, got {self.grid}")
        self.ndim = len(self.grid)
        self.dist = _normalize_dist({} if dist is None else dist, self.ndim)

        nproc = math.prod(self.grid)
        if proclist is None:
            proclist = range(nproc)
        self.proclist = tuple(int(p) for p in proclist)
        if len(self.proclist) != nproc:
            raise ValueError(
                f"processor list has {len(self.proclist)} entries; grid "
                f"{self.grid} needs {nproc}"
            )
        if len(set(self.proclist)) != nproc:
            raise ValueError("processor list contains duplicates")

        if overlap is None:
            overlap = (0,) * self.ndim
        self.overlap = tuple(int(o) for o in overlap)
        if len(self.overlap) != self.ndim:
            raise ValueError(
                f"overlap has {len(self.overlap)} entries for {self.ndim}-D grid"
            )
        if any(o < 0 for o in self.overlap):
            raise ValueError(f"overlap must be >= 0, got {self.overlap}")
        for d, ((kind, _), o) in enumerate(zip(self.dist, self.overlap)):
            if o > 0 and kind != "b":
                raise ValueError(
                    f"overlap only supported with block distribution (dim {d})"
                )

        if order not in ("row", "col"):
            raise ValueError(f"order must be 'row' or 'col', got {order!r}")
        self.order = order

    # -- processor-grid coordinates ---------------------------------------

    def grid_position(self, pid: int) -> tuple[int, ...]:
        """Grid coordinates of processor ``pid`` (must be in the map)."""
        idx = self.proclist.index(pid)
        if self.order == "row":
            return tuple(np.unravel_index(idx, self.grid, order="C"))
        return tuple(np.unravel_index(idx, self.grid, order="F"))

    def pid_at(self, coords: Sequence[int]) -> int:
        ordr = "C" if self.order == "row" else "F"
        flat = int(np.ravel_multi_index(tuple(coords), self.grid, order=ordr))
        return self.proclist[flat]

    def inmap(self, pid: int) -> bool:
        """Whether processor ``pid`` holds any data under this map."""
        return pid in self.proclist

    # -- index algebra (delegates to PITFALLS) -----------------------------

    def _check_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        shape = tuple(int(s) for s in shape)
        if len(shape) != self.ndim:
            raise ValueError(
                f"array rank {len(shape)} does not match {self.ndim}-D map"
            )
        return shape

    def dim_falls(self, shape: Sequence[int], dim: int, pid: int) -> list[FALLS]:
        """Owned (no-overlap) FALLS of ``pid`` along ``dim`` for ``shape``."""
        shape = self._check_shape(shape)
        coord = self.grid_position(pid)[dim]
        kind, b = self.dist[dim]
        spec = {"dist": kind, "size": b} if kind == "bc" else kind
        return dist_falls(shape[dim], self.grid[dim], coord, spec)

    def local_indices(self, shape: Sequence[int], dim: int, pid: int) -> np.ndarray:
        """Sorted owned global indices of ``pid`` along ``dim``."""
        return falls_list_indices(self.dim_falls(shape, dim, pid))

    def local_shape(self, shape: Sequence[int], pid: int) -> tuple[int, ...]:
        """Shape of pid's local part, *including* overlap halo."""
        shape = self._check_shape(shape)
        if not self.inmap(pid):
            return tuple(0 for _ in shape)
        out = []
        for d in range(self.ndim):
            owned = falls_list_size(self.dim_falls(shape, d, pid))
            out.append(owned + self.halo_extent(shape, d, pid))
        return tuple(out)

    def halo_extent(self, shape: Sequence[int], dim: int, pid: int) -> int:
        """Halo cells past the owned end along ``dim`` (block+overlap only)."""
        o = self.overlap[dim]
        if o == 0:
            return 0
        shape = self._check_shape(shape)
        coord = self.grid_position(pid)[dim]
        if coord >= self.grid[dim] - 1:
            return 0  # last processor in the dim: nothing to its right
        fs = self.dim_falls(shape, dim, pid)
        if not fs:
            return 0
        end = fs[-1].last  # inclusive owned end
        # halo cannot exceed the successor's owned extent (single-neighbor
        # halo exchange, as in pMatlab)
        nxt = list(self.grid_position(pid))
        nxt[dim] += 1
        succ_fs = self.dim_falls(shape, dim, self.pid_at(nxt))
        succ_len = sum(f.n * f.seg_len for f in succ_fs)
        return max(0, min(o, shape[dim] - 1 - end, succ_len))

    def global_block_range(
        self, shape: Sequence[int], dim: int, pid: int
    ) -> tuple[int, int]:
        """Half-open owned global range along ``dim`` (block dists only)."""
        fs = self.dim_falls(shape, dim, pid)
        if not fs:
            return (0, 0)
        if len(fs) != 1 or fs[0].n != 1:
            raise ValueError(
                "global_block_range is only defined for contiguous (block) "
                "distributions; use local_indices for cyclic maps"
            )
        return (fs[0].l, fs[0].r + 1)

    # -- serialization ------------------------------------------------------

    def to_json(self) -> dict:
        """JSON-safe description of this map (checkpoint manifests).

        The inverse is :meth:`from_json`; the round trip is exact
        (``Dmap.from_json(m.to_json()) == m``) because ``parse_dist``
        re-parses its own canonical ``(kind, block)`` tuples."""
        return {
            "grid": list(self.grid),
            "dist": [[kind, int(b)] for kind, b in self.dist],
            "proclist": list(self.proclist),
            "overlap": list(self.overlap),
            "order": self.order,
        }

    @classmethod
    def from_json(cls, spec: dict) -> "Dmap":
        return cls(
            spec["grid"],
            [tuple(d) for d in spec["dist"]],
            proclist=spec["proclist"],
            overlap=spec.get("overlap"),
            order=spec.get("order", "row"),
        )

    # -- misc ---------------------------------------------------------------

    @property
    def np_(self) -> int:
        return len(self.proclist)

    def is_pure_block(self) -> bool:
        return all(kind == "b" for kind, _ in self.dist)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Dmap)
            and self.grid == other.grid
            and self.dist == other.dist
            and self.proclist == other.proclist
            and self.overlap == other.overlap
            and self.order == other.order
        )

    def __hash__(self) -> int:
        return hash((self.grid, self.dist, self.proclist, self.overlap, self.order))

    def __repr__(self) -> str:
        return (
            f"Dmap(grid={list(self.grid)}, dist={self.dist}, "
            f"proclist={list(self.proclist)}, overlap={list(self.overlap)}, "
            f"order={self.order!r})"
        )
