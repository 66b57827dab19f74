"""Multi-rank self-test of the torch bridge (the port of
``repro.launch._jax_selftest``): run it inside a world, one process a
rank, e.g.

    REPRO_COORD=127.0.0.1:29511 REPRO_NUM_HOSTS=1 REPRO_HOST_ID=0 \\
        python -m repro_torch.launch.distributed_init \\
        repro_torch.launch._torch_selftest:main

(``--device cpu`` before the target for a gloo group).  It shows the
cross-backend claim of the reference: the same Dmap gives every rank the
same local part through the ``DTensor`` lowering as through the paper's
index algebra, and redistribution moves values where PITFALLS says.
The expected locals come from the port's own ``core`` copies (owned
indices and halo extents from ``core.redist``, PITFALLS bytes), so the
test needs nothing of the JAX package; with ``dump_dir`` each rank also
writes its shards to ``rank<k>.npz`` for a caller to hold against
PythonMPI's.  The four checks:

1. device shard k equals rank k's local part;
2. the corner turn (``Dmap([W, 1])`` -> ``Dmap([1, W])``) keeps the values
   and the shard shapes, and the PITFALLS bytes are right; the same turn
   as a ``dist.hints.constrain`` hint under ``mesh_context`` gives the
   same shards;
3. cyclic canonicalisation round-trips and gives every rank its own
   cyclic indices;
4. the halo exchange equals ``synch``'s owned-plus-halo local.

Prints ``TORCH_BRIDGE_SELFTEST_OK`` on rank 0.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.dmap import Dmap
from ..core.redist import halo_extents_cached, owned_indices_cached
from ..core.torch_bridge import (
    apply_canonical_layout,
    expected_redistribution_bytes,
    halo_exchange,
    mesh_for_dmap,
    redistribute,
    scatter_to_mesh,
    undo_canonical_layout,
)
from ..dist.hints import constrain, mesh_context


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _grid2(world: int) -> list[int]:
    """A 2-D processor grid of ``world`` ranks: (2, W/2) where W is even
    (the reference's (2, 4) at 8), else (1, W)."""
    return [2, world // 2] if world % 2 == 0 else [1, world]


def expected_local(field: np.ndarray, dmap: Dmap, rank: int, halo: bool = False) -> np.ndarray:
    """Rank ``rank``'s local part of ``field`` under ``dmap`` from the index
    algebra: its owned indices per dim, extended by its halo extents."""
    shape = field.shape
    idx = owned_indices_cached(dmap, shape, rank)
    if halo:
        ext = halo_extents_cached(dmap, shape, rank)
        idx = tuple(np.concatenate([ix, ix[-1] + 1 + np.arange(e)]) if e else ix
                    for ix, e in zip(idx, ext))
    return field[np.ix_(*idx)]


def _local(x) -> np.ndarray:
    return x.to_local().cpu().numpy()


def test_shards_match_locals(world: int, rank: int) -> dict:
    """Device shard k == rank k's local part, same Dmap."""
    shape = (8, 16)
    dmap = Dmap(_grid2(world), {}, range(world))
    field = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    mesh = mesh_for_dmap(dmap, ("data", "model"))
    x = scatter_to_mesh(field, dmap, mesh, ("data", "model"))
    got = _local(x)
    np.testing.assert_array_equal(got, expected_local(field, dmap, rank))
    return {"shard": got}


def test_redistribute_corner_turn(world: int, rank: int) -> dict:
    """Z[:, :] = X (row map -> col map) by a placement change."""
    from torch.distributed.tensor import Replicate, Shard

    shape = (8, 16)
    row = Dmap([world, 1], {}, range(world))
    col = Dmap([1, world], {}, range(world))
    field = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    mesh = mesh_for_dmap(row, ("data", "model"))  # grid (W, 1)
    x = scatter_to_mesh(field, row, mesh, ("data", None))
    z = redistribute(x, (Shard(1), Replicate()))  # the col grid over the same ranks
    np.testing.assert_array_equal(z.full_tensor().cpu().numpy(), field)  # values kept
    got = _local(z)
    check(got.shape == (8, 16 // world), f"bad shard shape {got.shape}")
    np.testing.assert_array_equal(got, expected_local(field, col, rank))
    with mesh_context(mesh):  # the same turn as a hint; "model" is not sharded here
        hinted = constrain(x, None, "data")
        check(constrain(x, "pod", None).placements == (Replicate(), Replicate()),
              "an axis the mesh lacks did not replicate")
    np.testing.assert_array_equal(_local(hinted), got)
    pred = expected_redistribution_bytes(shape, 4, row, col)
    # all-but-diagonal blocks move: each rank keeps 1/W of its row block
    want = (8 * 16) * 4 * (world - 1) // world
    check(pred == want, f"PITFALLS bytes {pred} != {want}")
    return {"corner_turn": got, "corner_turn_bytes": np.int64(pred)}


def test_cyclic_canonicalization(world: int, rank: int) -> dict:
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor import Shard

    n, p = 24, 8
    x = torch.arange(n, dtype=torch.float32)
    y = apply_canonical_layout(x, 0, n, p, "c")
    perm = y.numpy().astype(np.int64)
    for r in range(p):  # rank r's cyclic indices are now contiguous
        seg = perm[r * 3 : (r + 1) * 3]
        check(all(int(v) % p == r for v in seg), f"rank {r} segment {seg}")
    np.testing.assert_array_equal(undo_canonical_layout(y, 0, n, p, "c").numpy(), x.numpy())
    # over the world: block-shard the canonical layout of a cyclic map of
    # W ranks; every rank then holds exactly its cyclic indices
    m = 3 * world
    mesh = mesh_for_dmap(Dmap([world]), ("data",))
    cyc = Dmap([world], "c", range(world))
    canon = apply_canonical_layout(torch.arange(m, dtype=torch.float32), 0, m, world, "c")
    got = _local(distribute_tensor(canon.to(mesh.device_type), mesh, (Shard(0),)))
    want = owned_indices_cached(cyc, (m,), rank)[0].astype(np.float32)
    np.testing.assert_array_equal(got, want)
    back = distribute_tensor(canon.to(mesh.device_type), mesh, (Shard(0),)).redistribute(
        mesh, (Replicate(),)).to_local()
    np.testing.assert_array_equal(undo_canonical_layout(back, 0, m, world, "c").cpu().numpy(),
                                  np.arange(m, dtype=np.float32))
    return {"cyclic": got}


def test_halo_exchange_matches_synch(world: int, rank: int) -> dict:
    shape = (16, 4)
    overlap = 2
    dmap = Dmap([world, 1], {}, range(world), overlap=[overlap, 0])
    field = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    mesh = mesh_for_dmap(Dmap([world, 1], {}, range(world)), ("data", "model"))
    x = scatter_to_mesh(field, Dmap([world, 1], {}, range(world)), mesh, ("data", None))
    got = _local(halo_exchange(x, mesh, "data", 0, overlap))
    want = expected_local(field, dmap, rank, halo=True)
    # the last shard's halo is zero padding; compare owned + halo
    np.testing.assert_array_equal(got[: want.shape[0]], want)
    check(not got[want.shape[0]:].any(), "the padding past the last halo is not zero")
    return {"halo": got}


def main(dump_dir: str | None = None) -> None:
    import torch.distributed as dist

    check(dist.is_initialized(), "run inside a world (repro_torch.launch.distributed_init)")
    world, rank = dist.get_world_size(), dist.get_rank()
    check(8 % world == 0, f"a world of 1, 2, 4 or 8 ranks (the shapes split evenly), not {world}")
    out: dict = {}
    for test in (test_shards_match_locals, test_redistribute_corner_turn,
                 test_cyclic_canonicalization, test_halo_exchange_matches_synch):
        out.update(test(world, rank))
        dist.barrier()
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        np.savez(os.path.join(dump_dir, f"rank{rank}.npz"), **out)
    if rank == 0:
        print(f"TORCH_BRIDGE_SELFTEST_OK world={world} backend={dist.get_backend()}",
              flush=True)
