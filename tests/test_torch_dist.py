"""The port's distribution layer against the JAX package's.

* ``repro_torch.dist.sharding``: for every arch and the mesh shapes
  (1, 1), (2, 4), (16, 16) and (2, 16, 16), the param, optimizer,
  batch, logits, decode-state and serve-carry specs equal the
  reference's ``PartitionSpec`` entries leaf by leaf.  The reference's
  trees are built on a ``jax.sharding.AbstractMesh`` (sizes and names,
  no devices), as the port's are on a mapping of them.
* ``repro_torch.dist.memmodel``: ``analytic_memory`` equals the
  reference's, integer for integer, for every arch and kind at (1, 1)
  and (2, 4).
* Data-parallel training (``repro_torch.launch.train --data-model 2 1``
  over a gloo group of 2 processes, each a subprocess with its own
  timeout meeting at a ``FileStore`` under ``tmp_path``): losses within
  1e-5 relative of the one-process run on the same global batch and
  parameters bitwise equal across the ranks, with microbatches and with
  bf16 and int8 gradient compression.
* Start-up: ``distributed_init`` parses both environments; NCCL without
  a card raises; the CLI refuses a model axis and a mesh with no world.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.dist import memmodel as jm  # noqa: E402
from repro.dist import sharding as js  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.dist import memmodel as tm  # noqa: E402
from repro_torch.dist import sharding as ts  # noqa: E402
from repro_torch.launch import distributed_init as di  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.train.data import shard_batch, synthetic_batch  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MESHES = {"1x1": (("data", "model"), (1, 1)), "2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
# (function, its arguments after (cfg, mesh)): batch sizes that the data
# axes divide at some meshes and not at others (then replicated)
TREES = [("param_shardings", ()), ("opt_state_shardings", ()),
         ("batch_shardings", ("train", 32)), ("batch_shardings", ("prefill", 8)),
         ("batch_shardings", ("decode", 64)), ("logits_sharding", (16,)),
         ("decode_state_shardings", (64, 128)), ("decode_state_shardings", (6, 128)),
         ("serve_carry_shardings", (32, 128))]


def _meshes(key):
    names, sizes = MESHES[key]
    return AbstractMesh(sizes, names), dict(zip(names, sizes))


def _jax_specs(tree):
    return [tuple(s.spec) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))]


def _port_specs(tree):
    if isinstance(tree, ts.Sharding):
        return [tree.spec]
    return [s.spec for s in leaves(tree)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_the_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jcfg, tcfg = jax_config(arch), port_config(arch)
    for fn, args in TREES:
        want = getattr(js, fn)(jcfg, jmesh, *args)
        got = getattr(ts, fn)(tcfg, tmesh, *args)
        assert _port_specs(got) == _jax_specs(want), (fn, args)
        if isinstance(want, dict):  # the same keys, leaf for leaf
            assert jax.tree.structure(jax.tree.map(lambda s: 0, want, is_leaf=lambda x: isinstance(
                x, NamedSharding))) == jax.tree.structure(
                jax.tree.map(lambda s: 0, got, is_leaf=lambda x: isinstance(x, ts.Sharding)))


@pytest.mark.parametrize("mesh", ["1x1", "2x4"])
@pytest.mark.parametrize("arch", list_archs())
def test_analytic_memory_equals_the_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jcfg, tcfg = jax_config(arch), port_config(arch)
    assert tm.param_bytes_per_device(tcfg, tmesh) == jm.param_bytes_per_device(jcfg, jmesh)
    for kind, batch, seq in (("train", 16, 256), ("prefill", 8, 512), ("decode", 16, 1024)):
        want = jm.analytic_memory(jcfg, jmesh, kind, batch, seq, microbatches=2)
        got = tm.analytic_memory(tcfg, tmesh, kind, batch, seq, microbatches=2)
        assert got.pop("fits_h100_80gb") == (got["total"] <= tm.H100_HBM_BYTES)
        want.pop("fits_v5e_16gb")
        assert got == want, kind


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_trees_equal_the_reference(arch):
    """The shapes and dtypes the memory model counts: the params (bf16
    but the fp32 leaves) and the decode state, on the meta device."""
    from repro.models.model import abstract_decode_state as jax_state
    from repro.models.model import abstract_params as jax_params
    from repro_torch.models.model import abstract_decode_state, abstract_params

    def flat(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}/{k}")
            else:
                yield f"{prefix}/{k}", tuple(v.shape), str(v.dtype).removeprefix("torch.")

    for got, want in ((abstract_params(port_config(arch)), jax_params(jax_config(arch))),
                      (abstract_decode_state(port_config(arch), 3, 40),
                       jax_state(jax_config(arch), 3, 40))):
        assert all(t.device.type == "meta" for t in leaves(got))
        assert list(flat(got)) == list(flat(want))


def test_production_mesh_shapes():
    from repro_torch.launch.mesh import production_shape

    assert production_shape(256) == ((32, 8), ("data", "model"))
    assert production_shape(512, multi_pod=True) == ((2, 32, 8), ("pod", "data", "model"))
    with pytest.raises(ValueError):
        production_shape(12)
    with pytest.raises(ValueError):
        production_shape(24, multi_pod=True)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 16, "model": 16}
    assert ts.placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert ts.placements(mesh, ()) == (Replicate(),) * 3
    assert ts.placements(mesh, (None, "model")) == (Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError):
        ts.placements(mesh, ("data", "data"))
    sh = ts.param_shardings(port_config("gemma-2b"), {"data": 2, "model": 4})
    wq = sh["layers"]["attn"]["wq"]
    assert wq.placements == (Replicate(), Shard(2))
    assert wq.shard_shape((18, 2048, 2048)) == (18, 2048, 512)


def test_constrain_is_the_identity_off_a_mesh_and_on_local_tensors():
    from repro_torch.dist import constrain, current_mesh, mesh_context

    x = torch.arange(6.0).view(2, 3)
    assert constrain(x, "data", "model") is x and current_mesh() is None
    outer, inner = object(), object()
    with mesh_context(outer):
        with mesh_context(inner):
            assert current_mesh() is inner
            assert constrain(x, "data") is x  # a local tensor: nothing to act on
        assert current_mesh() is outer
    assert current_mesh() is None


class _FakeMesh:
    """The part of a ``DeviceMesh`` that ``shard_batch`` reads."""

    def __init__(self, sizes: dict, coords: dict):
        self.mesh_dim_names, self.shape = tuple(sizes), tuple(sizes.values())
        self._coords = coords

    def get_local_rank(self, name):
        return self._coords[name]


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-vl-72b", "musicgen-medium"])
def test_shard_batch_takes_this_ranks_rows(arch):
    cfg = port_config(arch).reduced()
    batch = synthetic_batch(cfg, 8, 6, step=3, device="cpu")
    for d in range(4):
        got = shard_batch(cfg, batch, _FakeMesh({"data": 4, "model": 1}, {"data": d, "model": 0}))
        assert set(got) == set(batch)
        for key, x in batch.items():
            axis = 1 if key == "positions" else 0  # M-RoPE's (3, B, S)
            assert torch.equal(got[key], x.narrow(axis, 2 * d, 2)), key
    # a batch the data axis does not divide is replicated, as the reference places it
    odd = synthetic_batch(cfg, 6, 6, step=3, device="cpu")
    got = shard_batch(cfg, odd, _FakeMesh({"data": 4, "model": 1}, {"data": 1, "model": 0}))
    assert all(torch.equal(got[k], odd[k]) for k in odd)


def test_world_from_env_reads_both_environments():
    assert di.world_from_env({}) is None
    spec = di.world_from_env({"REPRO_COORD": "10.0.0.1:1234", "REPRO_NUM_HOSTS": "16",
                              "REPRO_HOST_ID": "5", "REPRO_LOCAL_RANK": "5"})
    assert spec == di.WorldSpec("tcp://10.0.0.1:1234", 16, 5, 5)
    spec = di.world_from_env({"REPRO_COORD": "file:///tmp/x/store", "REPRO_NUM_HOSTS": "2",
                              "REPRO_HOST_ID": "1"})
    assert spec == di.WorldSpec("file:///tmp/x/store", 2, 1, 0)
    spec = di.world_from_env({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29400",
                              "RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "3"})
    assert spec == di.WorldSpec("tcp://127.0.0.1:29400", 8, 3, 3)


def test_nccl_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = di.WorldSpec("file:///nonexistent/store", 1, 0, 0)
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        di.init_process_group(spec, "cuda")
    with pytest.raises(ValueError):
        di.init_process_group(spec, "tpu")


def test_cli_refuses_a_model_axis_and_a_mesh_without_a_world():
    dev = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item 7"):
        cli.data_mesh((1, 2), dev)
    with pytest.raises(RuntimeError, match="running world"):
        cli.data_mesh((1, 1), dev)
    assert cli.data_mesh(None, dev) is None


def _run_ranks(tmp_path: Path, world: int, argv: list, timeout: int = 240) -> list:
    """The worker over ``world`` gloo ranks; returns each rank's dump."""
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO / 'tests'}",
               REPRO_NUM_HOSTS=str(world), REPRO_COORD=f"file://{tmp_path / 'store'}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.distributed_init", "--device", "cpu",
         str(REPO / "tests" / "_torch_dp_worker.py"), str(out), *argv],
        env=dict(env, REPRO_HOST_ID=str(r)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
        assert f"DRIFT_DETECTED rank {r}" in log
    return [np.load(out / f"rank{r}.npz") for r in range(world)]


DP_CASES = {"plain": [], "microbatched": ["--microbatches", "2"],
            "bf16": ["--grad-compression", "bf16"],
            "int8_ef": ["--grad-compression", "int8_ef", "--microbatches", "2"]}


@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_data_parallel_training_matches_one_process(tmp_path, case):
    """Reduced gemma-2b, 3 steps of batch 4 × 16, over 2 gloo ranks
    against one process on the same global batch."""
    argv = ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "16", *DP_CASES[case]]
    ranks = _run_ranks(tmp_path, 2, argv + ["--data-model", "2", "1",
                                            "--ckpt-dir", str(tmp_path / "ck2")])
    params, _, history = cli.run(cli.parse_args(argv + ["--ckpt-dir", str(tmp_path / "ck1")]))
    want = np.array([h["loss"] for h in history])
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5, atol=0, err_msg=f"rank {r}")
        # bf16: each rank rounds its own gradient, one bf16 unit (2^-8)
        np.testing.assert_allclose(got["grad_norms"], [h["grad_norm"] for h in history],
                                   rtol=2.0 ** -8 if case == "bf16" else 1e-5, atol=0)
    names = [k for k in ranks[0].files if k.startswith("p")]
    assert len(names) == len(leaves(params))
    for k in names:  # the replicas never drift
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    # rank 0 wrote the final checkpoint
    assert (tmp_path / "ck2" / "step-00000003").is_dir()
