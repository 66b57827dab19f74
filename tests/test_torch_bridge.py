"""The port's Dmap -> ``torch.distributed`` bridge
(``repro_torch.core.torch_bridge``) against the JAX package's
``repro.core.jax_bridge`` and PythonMPI.

In-process: placements, the canonical permutation and the PITFALLS byte
oracle against the reference's.  Multi-rank: the self-test
(``repro_torch.launch._torch_selftest``) over gloo groups of 8 and 2
processes, each a subprocess with its own timeout, meeting at a
``FileStore`` under ``tmp_path``; the shards each rank dumps are held
against the locals of the same Dmap program run over PythonMPI
(``repro.comm.run_spmd`` with ``repro.core.scatter``/``synch``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as pp  # noqa: E402
from repro.comm import run_spmd  # noqa: E402
from repro.core import Dmap as JDmap  # noqa: E402
from repro.core import jax_bridge as jb  # noqa: E402
from repro_torch.core import torch_bridge as tb  # noqa: E402
from repro_torch.core.dmap import Dmap  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DISTS = ["b", "c", {"dist": "bc", "size": 3}]


def test_placements_of_block_maps():
    from torch.distributed.tensor import Replicate, Shard

    m = Dmap([4, 2], {}, range(8))
    assert tb.dmap_to_placements(m, ("data", "model"), ("data", "model")) == (Shard(0), Shard(1))
    assert tb.dmap_to_placements(m, ("model", "data"), ("data", "model")) == (Shard(1), Shard(0))
    m = Dmap([4, 1], {}, range(4))
    assert tb.dmap_to_placements(m, ("data", None), ("data", "model")) == (Shard(0), Replicate())


@pytest.mark.parametrize("dim_axes", [("data", None), ("data",)], ids=["unbound", "short"])
def test_placements_refuse_what_the_reference_refuses(dim_axes):
    for bridge, dmap, call in (
            (jb, JDmap([4, 2], {}, range(8)), lambda m: jb.dmap_to_partition_spec(m, dim_axes)),
            (tb, Dmap([4, 2], {}, range(8)),
             lambda m: tb.dmap_to_placements(m, dim_axes, ("data", "model")))):
        with pytest.raises(ValueError):
            call(dmap)


@pytest.mark.parametrize("dist", DISTS, ids=["b", "c", "bc3"])
@pytest.mark.parametrize("n,p", [(24, 8), (17, 4), (5, 8), (128, 3)])
def test_canonical_layout_equals_the_reference(n, p, dist):
    want = jb.canonical_permutation(n, p, dist)
    np.testing.assert_array_equal(tb.canonical_permutation(n, p, dist), want)
    x = torch.arange(n, dtype=torch.float32) * 3
    y = tb.apply_canonical_layout(x, 0, n, p, dist)
    np.testing.assert_array_equal(y.numpy(), x.numpy()[want])
    np.testing.assert_array_equal(tb.undo_canonical_layout(y, 0, n, p, dist).numpy(), x.numpy())


BYTES_CASES = [
    ((8, 16), 4, ([8, 1], {}), ([1, 8], {})),
    ((8, 16), 2, ([2, 4], {}), ([4, 2], {})),
    ((30, 7), 4, ([3, 1], "c"), ([1, 2], {})),
    ((12, 12), 8, ([2, 2], {"dist": "bc", "size": 2}), ([4, 1], "c")),
    ((9, 10), 4, ([3, 1], {}), ([3, 1], {})),
]


@pytest.mark.parametrize("case", range(len(BYTES_CASES)))
def test_expected_redistribution_bytes_equals_the_reference(case):
    shape, item, (sg, sd), (dg, dd) = BYTES_CASES[case]
    want = jb.expected_redistribution_bytes(
        shape, item, JDmap(sg, sd), JDmap(dg, dd))
    assert tb.expected_redistribution_bytes(shape, item, Dmap(sg, sd), Dmap(dg, dd)) == want


def _run_world(tmp_path: Path, world: int, target: str, *args: str, timeout: int = 240):
    """``world`` processes of ``distributed_init --device cpu target args``,
    meeting at a FileStore under ``tmp_path``; returns their outputs."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), REPRO_NUM_HOSTS=str(world),
               REPRO_COORD=f"file://{tmp_path / 'store'}", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.distributed_init", "--device", "cpu",
         target, *args], env=dict(env, REPRO_HOST_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return outs


def _mpi_locals(world: int) -> dict:
    """The same Dmap program over PythonMPI (threads): each rank's owned
    part of the 2-D map, of the corner turn's column map, of the cyclic
    map, and its local after ``synch`` of the overlapped row map."""
    shape = (8, 16)
    field = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    grid = [2, world // 2] if world % 2 == 0 else [1, world]
    halo_field = np.arange(64, dtype=np.float32).reshape(16, 4)
    cyc = np.arange(3 * world, dtype=np.float32)

    def body():
        out = {"shard": pp.scatter(field, JDmap(grid, {}, range(world))).local_view_owned(),
               "corner_turn": pp.scatter(field, JDmap([1, world], {}, range(world)))
               .local_view_owned(),
               "cyclic": pp.scatter(cyc, JDmap([world], "c", range(world))).local_view_owned()}
        a = pp.scatter(halo_field, JDmap([world, 1], {}, range(world), overlap=[2, 0]))
        pp.synch(a)
        out["halo"] = np.array(a.local)
        return out

    return run_spmd(body, world)


@pytest.mark.parametrize("world", [8, 2])
def test_selftest_matches_pythonmpi_locals(tmp_path, world):
    """The bridge's self-test over ``world`` gloo ranks; every rank's
    shards equal PythonMPI's locals for the same Dmap, the halo's
    owned-plus-halo rows equal ``synch``'s, and the PITFALLS bytes of the
    corner turn equal the reference's."""
    dump = tmp_path / "dump"
    outs = _run_world(tmp_path, world, "repro_torch.launch._torch_selftest:main", str(dump))
    assert f"TORCH_BRIDGE_SELFTEST_OK world={world} backend=gloo" in outs[0]
    mpi = _mpi_locals(world)
    want_bytes = jb.expected_redistribution_bytes(
        (8, 16), 4, JDmap([world, 1], {}, range(world)), JDmap([1, world], {}, range(world)))
    for rank in range(world):
        got = np.load(dump / f"rank{rank}.npz")
        for key in ("shard", "corner_turn", "cyclic"):
            np.testing.assert_array_equal(got[key], mpi[rank][key], err_msg=f"{rank} {key}")
        want = mpi[rank]["halo"]
        np.testing.assert_array_equal(got["halo"][: want.shape[0]], want)
        assert int(got["corner_turn_bytes"]) == want_bytes
