"""PITFALLS: Processor Indexed Tagged FAmiLy of Line Segments.

The index algebra behind pPython's general redistribution (paper §III.C,
after Ramaswamy & Banerjee, Frontiers '95).  A FALLS describes a periodic
family of index segments; a distribution assigns one or two FALLS to every
processor of a dimension's grid.  Intersecting the FALLS of a source rank
with those of a destination rank yields *exactly* the global indices the
pair must exchange — this drives

  * ``Dmat.__setitem__`` redistribution on the PythonMPI backend,
  * elastic checkpoint resharding (save at Np, restore at Np'),
  * validation of the JAX collective lowering (the XLA all-to-all must move
    the same bytes PITFALLS predicts).

pPython enhancement (paper Fig. 5): for a block distribution with
``N % p != 0`` the remainder is dealt one element at a time starting from
rank 0, so every rank receives ``floor(N/p)`` or ``ceil(N/p)`` elements and
no trailing rank is starved (the naive ``ceil`` blocking can leave rank
``p-1`` empty, e.g. 16 elements over 5 ranks -> 4,4,4,4,0).

The port's own copy of ``repro.core.pitfalls`` (NumPy only): the
checkpoint's FALLS segment reads need it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = [
    "FALLS",
    "falls_indices",
    "falls_size",
    "falls_intersect",
    "falls_list_intersect",
    "falls_list_size",
    "block_falls",
    "cyclic_falls",
    "block_cyclic_falls",
    "dist_falls",
    "intersect_ranks",
]


@dataclass(frozen=True)
class FALLS:
    """A FAmiLy of Line Segments: ``n`` segments ``[l + i*s, r + i*s]``.

    ``l``/``r`` are the first segment's inclusive global start/end, ``s`` the
    stride between successive segment starts, ``n`` the segment count.
    Invariant: ``r >= l`` and (for n > 1) ``r - l + 1 <= s`` (segments are
    disjoint and ordered).
    """

    l: int
    r: int
    s: int
    n: int

    def __post_init__(self) -> None:
        if self.n < 0:
            raise ValueError(f"FALLS segment count must be >= 0, got {self.n}")
        if self.n > 0 and self.r < self.l:
            raise ValueError(f"FALLS segment end {self.r} < start {self.l}")
        if self.n > 1 and self.s < (self.r - self.l + 1):
            raise ValueError(
                f"FALLS stride {self.s} smaller than segment length "
                f"{self.r - self.l + 1}; segments would overlap"
            )

    @property
    def seg_len(self) -> int:
        return self.r - self.l + 1

    @property
    def last(self) -> int:
        """Largest index covered (only valid when n > 0)."""
        return self.r + (self.n - 1) * self.s


def falls_size(f: FALLS) -> int:
    """Number of indices covered by ``f``."""
    return 0 if f.n == 0 else f.n * f.seg_len


def falls_indices(f: FALLS) -> np.ndarray:
    """Explicit sorted global indices of ``f`` (test oracle; O(size))."""
    if f.n == 0:
        return np.empty(0, dtype=np.int64)
    starts = f.l + f.s * np.arange(f.n, dtype=np.int64)
    return (starts[:, None] + np.arange(f.seg_len, dtype=np.int64)[None, :]).ravel()


def _pair_intersection(a_lo: int, a_hi: int, b_lo: int, b_hi: int):
    lo, hi = max(a_lo, b_lo), min(a_hi, b_hi)
    return (lo, hi) if lo <= hi else None


def falls_intersect(f1: FALLS, f2: FALLS) -> list[FALLS]:
    """Intersect two FALLS, returning a list of disjoint FALLS.

    Uses the periodic-class algorithm: with ``T = lcm(s1, s2)``, segment
    pairs ``(i, j)`` and ``(i + T/s1, j + T/s2)`` have identical relative
    offset, so only class representatives (``i < T/s1`` or ``j < T/s2``) are
    examined; each non-empty representative intersection extends to a FALLS
    of stride ``T`` whose count is bounded by how many translates stay in
    range for both families.  Work is O(T/s1 + T/s2), independent of n.
    """
    if f1.n == 0 or f2.n == 0:
        return []
    if f1.n == 1 and f2.n == 1:
        hit = _pair_intersection(f1.l, f1.r, f2.l, f2.r)
        return [FALLS(hit[0], hit[1], max(hit[1] - hit[0] + 1, 1), 1)] if hit else []

    s1 = f1.s if f1.n > 1 else max(f1.seg_len, 1)
    s2 = f2.s if f2.n > 1 else max(f2.seg_len, 1)
    T = math.lcm(s1, s2)
    c1 = T // s1  # segments of f1 per period
    c2 = T // s2

    out: list[FALLS] = []

    def emit(i: int, j: int) -> None:
        """Intersect segment i of f1 with segment j of f2; extend periodically."""
        a_lo = f1.l + i * s1
        a_hi = f1.r + i * s1
        b_lo = f2.l + j * s2
        b_hi = f2.r + j * s2
        hit = _pair_intersection(a_lo, a_hi, b_lo, b_hi)
        if hit is None:
            return
        count = 1 + min((f1.n - 1 - i) // c1, (f2.n - 1 - j) // c2)
        out.append(FALLS(hit[0], hit[1], T, count))

    def j_window(i: int) -> range:
        """j values whose segment could touch segment i of f1."""
        a_lo = f1.l + i * s1
        a_hi = f1.r + i * s1
        j_lo = math.floor((a_lo - f2.r) / s2)
        j_hi = math.floor((a_hi - f2.l) / s2)
        return range(max(j_lo, 0), min(j_hi, f2.n - 1) + 1)

    def i_window(j: int) -> range:
        b_lo = f2.l + j * s2
        b_hi = f2.r + j * s2
        i_lo = math.floor((b_lo - f1.r) / s1)
        i_hi = math.floor((b_hi - f1.l) / s1)
        return range(max(i_lo, 0), min(i_hi, f1.n - 1) + 1)

    seen: set[tuple[int, int]] = set()
    for i in range(min(f1.n, c1)):
        for j in j_window(i):
            if (i, j) not in seen:
                seen.add((i, j))
                emit(i, j)
    for j in range(min(f2.n, c2)):
        for i in i_window(j):
            # only class representatives not already covered above
            if (i, j) not in seen and min(i // c1, j // c2) == 0:
                seen.add((i, j))
                emit(i, j)
    return _normalize(out)


def _normalize(fs: list[FALLS]) -> list[FALLS]:
    """Sort by first index and merge single-segment FALLS that are adjacent."""
    fs = sorted((f for f in fs if f.n > 0), key=lambda f: (f.l, f.r))
    merged: list[FALLS] = []
    for f in fs:
        if (
            merged
            and merged[-1].n == 1
            and f.n == 1
            and f.l == merged[-1].r + 1
        ):
            prev = merged.pop()
            length = f.r - prev.l + 1
            merged.append(FALLS(prev.l, f.r, max(length, 1), 1))
        else:
            merged.append(f)
    return merged


def falls_list_intersect(a: Sequence[FALLS], b: Sequence[FALLS]) -> list[FALLS]:
    """Intersection of two unions-of-FALLS (each union internally disjoint)."""
    out: list[FALLS] = []
    for fa in a:
        for fb in b:
            out.extend(falls_intersect(fa, fb))
    return _normalize(out)


def falls_list_size(a: Sequence[FALLS]) -> int:
    return sum(falls_size(f) for f in a)


def falls_list_indices(a: Sequence[FALLS]) -> np.ndarray:
    if not a:
        return np.empty(0, dtype=np.int64)
    return np.sort(np.concatenate([falls_indices(f) for f in a]))


# ---------------------------------------------------------------------------
# Distributions -> per-rank FALLS
# ---------------------------------------------------------------------------


def block_falls(n: int, p: int, rank: int) -> list[FALLS]:
    """pPython *enhanced* block distribution (paper Fig. 5).

    ``floor(n/p)`` per rank with the remainder dealt one-by-one from rank 0,
    guaranteeing a fair share whenever ``n >= p``.
    """
    if not (0 <= rank < p):
        raise ValueError(f"rank {rank} out of range for p={p}")
    base, rem = divmod(n, p)
    size = base + (1 if rank < rem else 0)
    if size == 0:
        return []
    start = rank * base + min(rank, rem)
    return [FALLS(start, start + size - 1, max(size, 1), 1)]


def cyclic_falls(n: int, p: int, rank: int) -> list[FALLS]:
    """Cyclic distribution: rank k owns indices ``k, k+p, k+2p, ...``."""
    if not (0 <= rank < p):
        raise ValueError(f"rank {rank} out of range for p={p}")
    count = max(0, -(-(n - rank) // p)) if rank < n else 0
    if count == 0:
        return []
    return [FALLS(rank, rank, p, count)]


def block_cyclic_falls(n: int, p: int, rank: int, b: int) -> list[FALLS]:
    """Block-cyclic with block size ``b``: rank k owns blocks ``k, k+p, ...``.

    The final block may be truncated by the dimension end, producing a
    second single-segment FALLS.
    """
    if not (0 <= rank < p):
        raise ValueError(f"rank {rank} out of range for p={p}")
    if b < 1:
        raise ValueError(f"block size must be >= 1, got {b}")
    stride = p * b
    first = rank * b
    if first >= n:
        return []
    # number of blocks starting before n
    n_blocks = 1 + (n - 1 - first) // stride
    last_start = first + (n_blocks - 1) * stride
    out: list[FALLS] = []
    if last_start + b <= n:
        out.append(FALLS(first, first + b - 1, stride, n_blocks))
    else:
        if n_blocks > 1:
            out.append(FALLS(first, first + b - 1, stride, n_blocks - 1))
        out.append(FALLS(last_start, n - 1, max(n - last_start, 1), 1))
    return out


def dist_falls(n: int, p: int, rank: int, dist: dict | str | None) -> list[FALLS]:
    """Per-rank FALLS for one dimension given a distribution spec.

    Spec forms (paper §III.B): ``{}``/``None``/``'b'`` block; ``'c'`` cyclic;
    ``{'dist': 'bc', 'size': b}`` block-cyclic; ``{'dist': 'b'|'c'}``.
    """
    if p == 1:
        return [FALLS(0, n - 1, max(n, 1), 1)] if n > 0 else []
    kind, b = parse_dist(dist)
    if kind == "b":
        return block_falls(n, p, rank)
    if kind == "c":
        return cyclic_falls(n, p, rank)
    return block_cyclic_falls(n, p, rank, b)


def parse_dist(dist: dict | str | None) -> tuple[str, int]:
    """Normalize a per-dimension distribution spec to ``(kind, block_size)``."""
    if dist is None:
        return "b", 0
    if isinstance(dist, tuple):
        # already-normalized (kind, block_size) — idempotent re-parse, so
        # a Dmap's own ``dist`` entries can seed a derived map
        if len(dist) == 2 and dist[0] in ("b", "c", "bc"):
            return dist[0], int(dist[1])
        raise ValueError(f"unknown distribution tuple {dist!r}")
    if isinstance(dist, str):
        if dist in ("b", "block", ""):
            return "b", 0
        if dist in ("c", "cyclic"):
            return "c", 0
        raise ValueError(f"unknown distribution string {dist!r}")
    if isinstance(dist, dict):
        if not dist:
            return "b", 0
        kind = dist.get("dist", "b")
        if kind in ("b", "block"):
            return "b", 0
        if kind in ("c", "cyclic"):
            return "c", 0
        if kind in ("bc", "block-cyclic", "blockcyclic"):
            size = int(dist.get("size", dist.get("b", 1)))
            return "bc", size
        raise ValueError(f"unknown distribution kind {kind!r}")
    raise TypeError(f"distribution spec must be str|dict|None, got {type(dist)}")


def intersect_ranks(
    n: int,
    p_src: int,
    dist_src: dict | str | None,
    p_dst: int,
    dist_dst: dict | str | None,
    src_rank: int,
    dst_rank: int,
) -> list[FALLS]:
    """Global indices (as FALLS) rank ``src_rank`` must ship to ``dst_rank``."""
    a = dist_falls(n, p_src, src_rank, dist_src)
    b = dist_falls(n, p_dst, dst_rank, dist_dst)
    return falls_list_intersect(a, b)
