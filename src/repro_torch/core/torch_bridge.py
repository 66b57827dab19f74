"""Dmap -> ``torch.distributed`` lowering: PGAS maps as ``DTensor``
placements on a ``DeviceMesh`` (the port of ``repro.core.jax_bridge``).

The paper's transport (files on a shared filesystem) has no device
analogue; the *index algebra* does.  This module maps the Dmap construct
onto ``torch.distributed``'s mesh and placements, so that the map that
drives PythonMPI messages on the CPU drives NCCL (or gloo) collectives:

* ``dmap_to_placements``  — block maps become ``Shard``/``Replicate``
  placements, one per mesh dim.
* ``canonical_permutation`` — cyclic/block-cyclic maps are canonicalised
  by an index permutation that makes each rank's owned indices
  contiguous (the HPF trick), after which block sharding applies.
  ``DTensor`` has no cyclic placement; this is the documented semantic
  adaptation, as in the reference.
* ``redistribute``        — the paper's ``Z[:, :] = X``: a placement
  change, which ``DTensor`` lowers to all-to-all / all-gather.  PITFALLS
  stays in the loop as the *oracle*: ``expected_redistribution_bytes``
  predicts the traffic between ranks.
* ``halo_exchange``       — the overlap feature as point-to-point sends
  (``batch_isend_irecv``) along one mesh dim, the ``ppermute`` of the
  reference.

As in the reference, block sharding pads the *last* shard when
``n % p != 0`` while pPython's enhanced block deals remainders from rank
0; the two agree when ``p | n``, which ``scatter_to_mesh`` asserts on
distributed dims.  PythonMPI remains the reference for ragged shapes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .._device import group_device_type
from .dmap import Dmap
from .pitfalls import dist_falls, falls_list_indices, falls_list_intersect

__all__ = [
    "dmap_to_placements",
    "mesh_for_dmap",
    "canonical_permutation",
    "apply_canonical_layout",
    "undo_canonical_layout",
    "redistribute",
    "halo_exchange",
    "expected_redistribution_bytes",
    "scatter_to_mesh",
]


def _mesh_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", mesh)
    if names is None:
        raise ValueError("the mesh needs mesh_dim_names")
    return tuple(names)


def dmap_to_placements(dmap: Dmap, dim_axes: Sequence[str | None], mesh) -> tuple:
    """Placements on ``mesh`` (a ``DeviceMesh`` or its dim names) for a
    Dmap, given the mesh axis bound to each array dim.

    ``dim_axes[d]`` names the mesh axis sharding dim ``d`` (None =
    replicated; grid must be 1 there).  Cyclic/block-cyclic dims must be
    canonicalised first (``apply_canonical_layout``).
    """
    from torch.distributed.tensor import Replicate, Shard

    if len(dim_axes) != dmap.ndim:
        raise ValueError(f"dim_axes has {len(dim_axes)} entries for {dmap.ndim}-D map")
    owner = {}
    for d, axis in enumerate(dim_axes):
        g = dmap.grid[d]
        if axis is None:
            if g != 1:
                raise ValueError(
                    f"dim {d} has grid {g} but no mesh axis bound to it"
                )
        else:
            owner[axis] = d
    return tuple(Shard(owner[n]) if n in owner else Replicate() for n in _mesh_names(mesh))


def mesh_for_dmap(dmap: Dmap, axis_names: Sequence[str] | None = None,
                  device_type: str | None = None):
    """A ``DeviceMesh`` shaped like the map's processor grid.

    Ranks in proclist order, honouring the map's row/col ``order`` —
    pMatlab's column-major grids produce the transposed rank layout,
    exactly as the paper's ``order`` keyword.  ``device_type`` defaults to
    ``cuda`` on an NCCL group and ``cpu`` on gloo.  Collective: every rank
    of the world calls it.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if axis_names is None:
        axis_names = tuple(f"g{d}" for d in range(dmap.ndim))
    order = "C" if dmap.order == "row" else "F"
    ranks = np.asarray(dmap.proclist).reshape(dmap.grid, order=order)
    return DeviceMesh(device_type or group_device_type(), torch.as_tensor(ranks),
                      mesh_dim_names=tuple(axis_names))


# ---------------------------------------------------------------------------
# Cyclic canonicalization (HPF-style layout permutation)
# ---------------------------------------------------------------------------


def canonical_permutation(n: int, p: int, dist) -> np.ndarray:
    """Permutation ``perm`` with ``x[perm]`` rank-contiguous for ``dist``.

    Concatenates each rank's owned indices in rank order; for block dists
    this is the identity.  After the permutation the axis is block
    distributed (fair-share), so ``Shard`` applies.
    """
    parts = [falls_list_indices(dist_falls(n, p, r, dist)) for r in range(p)]
    perm = np.concatenate([x for x in parts if len(x)])
    if len(perm) != n:
        raise ValueError("distribution does not cover the axis")
    return perm


def apply_canonical_layout(x: torch.Tensor, dim: int, n: int, p: int, dist) -> torch.Tensor:
    perm = torch.as_tensor(canonical_permutation(n, p, dist), device=x.device)
    return x.index_select(dim, perm)


def undo_canonical_layout(x: torch.Tensor, dim: int, n: int, p: int, dist) -> torch.Tensor:
    perm = canonical_permutation(n, p, dist)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return x.index_select(dim, torch.as_tensor(inv, device=x.device))


# ---------------------------------------------------------------------------
# Redistribution (the paper's Z[:, :] = X)
# ---------------------------------------------------------------------------


def redistribute(x, dst: Sequence, mesh=None):
    """``x`` (a ``DTensor``) under the placements ``dst``: ``DTensor``
    emits the collectives that the PITFALLS algebra computes explicitly
    on the CPU backend."""
    return x.redistribute(mesh if mesh is not None else x.device_mesh, tuple(dst))


def expected_redistribution_bytes(
    shape: Sequence[int],
    itemsize: int,
    src: Dmap,
    dst: Dmap,
) -> int:
    """PITFALLS-predicted traffic between ranks for ``dst[...] = src``.

    Sums element counts over all (sender, receiver) pairs with
    ``sender != receiver``; the product over dims of per-dim intersection
    sizes is the pair's block volume.
    """
    shape = tuple(shape)
    total = 0
    for s_rank in src.proclist:
        for d_rank in dst.proclist:
            if s_rank == d_rank:
                continue
            vol = 1
            for d in range(len(shape)):
                a = src.dim_falls(shape, d, s_rank)
                b = dst.dim_falls(shape, d, d_rank)
                inter = falls_list_intersect(a, b)
                cnt = sum(f.n * f.seg_len for f in inter)
                if cnt == 0:
                    vol = 0
                    break
                vol *= cnt
            total += vol * itemsize
    return total


# ---------------------------------------------------------------------------
# Halo exchange (the paper's overlap) as point-to-point sends
# ---------------------------------------------------------------------------


def halo_exchange(x, mesh, axis: str, dim: int, overlap: int):
    """Append each shard's successor-facing halo along ``dim``.

    Equivalent of ``synch`` (paper §III.E) for block maps: every shard
    receives the first ``overlap`` slices of its successor along mesh dim
    ``axis`` and concatenates them past its owned end.  The last shard
    pads with zeros (non-periodic, like pPython's edge ranks).  ``x`` is a
    ``DTensor`` sharded over ``axis`` along ``dim``; the result is one too,
    each shard ``overlap`` longer.  Collective over the ranks of the mesh.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    local = x.to_local()
    lead = local.narrow(dim, 0, overlap).contiguous()
    halo = torch.zeros_like(lead)
    ops = []
    if me > 0:  # shard i sends its lead to shard i - 1
        ops.append(dist.P2POp(dist.isend, lead, ranks[me - 1], group))
    if me + 1 < len(ranks):  # and receives shard i + 1's
        ops.append(dist.P2POp(dist.irecv, halo, ranks[me + 1], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out = torch.cat([local, halo], dim=dim)
    return DTensor.from_local(out, mesh, x.placements, run_check=False)


def scatter_to_mesh(arr: np.ndarray, dmap: Dmap, mesh, dim_axes: Sequence[str | None]):
    """Place a host array on the mesh under the map's placements (every
    rank passes the same array; rank 0's is the one distributed)."""
    from torch.distributed.tensor import distribute_tensor

    names = _mesh_names(mesh)
    for d, axis in enumerate(dim_axes):
        if axis is not None:
            p = mesh.size(names.index(axis))
            assert arr.shape[d] % p == 0, (
                f"dim {d} ({arr.shape[d]}) is not divisible by mesh axis {axis} ({p})")
    t = torch.as_tensor(np.ascontiguousarray(arr)).to(mesh.device_type)
    return distribute_tensor(t, mesh, dmap_to_placements(dmap, dim_axes, mesh))
