"""The port's ``model`` mesh axis (``repro_torch.dist.shard``, the model
body's gather hook, training and checkpoints at (data, model) meshes)
against its one-process runs and the JAX package, on the CPU at reduced
sizes.

* init: ``init_params(..., mesh=)`` gives each rank the blocks that
  ``shard_tree`` cuts from the meshless init, bit for bit (also for a
  leaf drawn part by part), and ``block_of`` gives the even blocks of
  ``torch.chunk``.
* memory: each rank's parameter bytes (bf16, the fp32 leaves apart)
  equal ``dist.memmodel.param_bytes_per_device`` at its mesh.
* the hook: off a mesh, and on a mesh whose model axis is 1, the model
  calls no gather and no collective.
* training (``repro_torch.launch.train --data-model D M``) of reduced
  gemma-2b, deepseek-moe-16b and zamba2-2.7b at (1, 2) and (2, 2), 4
  steps, against the one-process run and JAX's jitted train step on the
  same weights and batches: losses and grad norms within 1e-5 relative;
  each rank's blocks of the params and both moments within 1e-6 of the
  one-process run's blocks, of the shapes ``param_shardings`` gives; the
  data-axis replicas bit for bit; at (1, 2) step 1's loss bitwise the
  one-process loss (at (2, 2) the data axis averages two half-batch
  means, one rounding apart from the whole batch's mean).
* the MoE capacity on the data axis: deepseek-moe-16b at (2, 1) with a
  batch the axis does not split (every rank the whole batch) and with
  two microbatches cut from the global batch, against JAX and the
  one-process run.
* the remat recompute: the layers' gathers run again in the backward,
  which is taken outside the mesh context (``models.model._remat``
  enters it again), and give the gradients of the run without remat
  bit for bit.
* checkpoints: a run at (1, 2) saves whole leaves, which the meshless
  port and the JAX package's ``CheckpointManager.restore`` read equal to
  the ranks' blocks joined, bit for bit; resumes at (1, 2) from step 2,
  (1, 2) -> (1, 1) and (1, 1) -> (2, 2) give the uninterrupted run's
  losses within 1e-5.

Each multi-rank run is N subprocesses of ``python -m
repro_torch.launch.distributed_init --device cpu
tests/_torch_model_axis_worker.py``, one thread each, meeting at a
``FileStore`` under the test's tmp dir; the one-process references run
the same way in a world of one, so both sides take the CPU's arithmetic
in the same order.
"""

import functools
import itertools
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_ranks import run_ranks  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import data as jax_data  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import train_step as jax_ts  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.dist import mesh_context  # noqa: E402
from repro_torch.dist import shard as dshard  # noqa: E402
from repro_torch.dist.memmodel import param_bytes_per_device  # noqa: E402
from repro_torch.dist.sharding import param_shardings  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402

INIT_ARCHS = ["gemma-2b", "deepseek-moe-16b", "zamba2-2.7b", "rwkv6-1.6b", "qwen2-vl-72b"]
TRAIN_ARCHS = ["gemma-2b", "deepseek-moe-16b", "zamba2-2.7b"]
STEPS, BATCH, SEQ = 4, 4, 16


class Coords:
    """A mesh shape and one rank's place on it: what ``block_of`` and
    ``init_params(..., mesh=)`` read of a ``DeviceMesh``."""

    def __init__(self, sizes: dict, coords: dict):
        self.mesh_dim_names, self.shape = tuple(sizes), tuple(sizes.values())
        self.coords = coords

    def get_local_rank(self, name):
        return self.coords[name]


def every_rank(data: int, model: int):
    """Each rank's ``Coords`` on a (data, model) mesh, in rank order."""
    for d, m in itertools.product(range(data), range(model)):
        yield Coords({"data": data, "model": model}, {"data": d, "model": m})


def _paths(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _specs(cfg, data, model) -> dict:
    return dict(_paths(param_shardings(cfg, {"data": data, "model": model})))


# ---------------------------------------------------------------------------
# blocks, init and memory, in one process
# ---------------------------------------------------------------------------


def test_block_of_gives_the_even_blocks():
    x = torch.arange(2 * 12 * 8).view(2, 12, 8)
    for c in every_rank(2, 4):
        got = dshard.shard_leaf(x, (None, "model", "data"), c)
        want = x.chunk(4, 1)[c.coords["model"]].chunk(2, 2)[c.coords["data"]]
        assert torch.equal(got, want) and got.is_contiguous()
        # a tuple entry splits one dim over both axes, major first
        both = dshard.block_of((16,), (("data", "model"),), c)
        assert both == [[2 * (4 * c.coords["data"] + c.coords["model"]),
                         2 * (4 * c.coords["data"] + c.coords["model"]) + 2]]
    assert dshard.shard_leaf(x, (), Coords({"data": 2, "model": 4}, {"data": 1, "model": 3})) is x


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("arch", INIT_ARCHS)
def test_sharded_init_equals_the_blocks_of_the_meshless_init(arch, mesh):
    cfg = port_config(arch).reduced()
    data, model = map(int, mesh.split("x"))
    whole = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    for c in every_rank(data, model):
        want = dshard.shard_tree(whole, param_shardings(cfg, c), c)
        got = init_params(cfg, seed=0, dtype=torch.float32, device="cpu", mesh=c)
        for (path, w), (_, g) in zip(_paths(want), _paths(got)):
            assert g.shape == w.shape and torch.equal(g, w), (path, c.coords)


def test_a_leaf_drawn_part_by_part_is_cut_part_by_part(monkeypatch):
    """The sliced draw (leaves over ``SLICED_DRAW_ELEMS``, here lowered so
    that the reduced expert stacks take it): each part is cut before the
    next is drawn, and the blocks are the meshless sliced init's."""
    monkeypatch.setattr(port_model, "SLICED_DRAW_ELEMS", 1000)
    cfg = port_config("deepseek-moe-16b").reduced()
    whole = init_params(cfg, seed=4, dtype=torch.bfloat16, device="cpu")
    for c in every_rank(2, 2):
        got = init_params(cfg, seed=4, dtype=torch.bfloat16, device="cpu", mesh=c)
        want = dshard.shard_tree(whole, param_shardings(cfg, c), c)
        for (path, w), (_, g) in zip(_paths(want), _paths(got)):
            assert torch.equal(g, w), path


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4", "2x4"])
@pytest.mark.parametrize("arch", INIT_ARCHS)
def test_param_bytes_equal_the_memory_model(arch, mesh):
    """bf16 params (the fp32 leaves apart), as the memory model counts
    them: every rank's bytes equal ``param_bytes_per_device``, integer
    for integer, and each leaf has the shape ``param_shardings`` gives."""
    cfg = port_config(arch).reduced()
    data, model = map(int, mesh.split("x"))
    sizes = {"data": data, "model": model}
    shapes = dict(_paths(port_model.param_shapes(cfg)))
    for c in every_rank(data, model):
        got = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu", mesh=c)
        for path, sh in _paths(param_shardings(cfg, sizes)):
            assert tuple(dict(_paths(got))[path].shape) == sh.shard_shape(shapes[path]), path
        held = sum(t.numel() * t.element_size() for t in leaves(got))
        assert held == param_bytes_per_device(cfg, sizes), c.coords
    if model > 1:
        full = sum(t.numel() * t.element_size()
                   for t in leaves(init_params(cfg, 0, dtype=torch.bfloat16, device="cpu")))
        assert param_bytes_per_device(cfg, sizes) < full


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-2.7b", "deepseek-moe-16b", "rwkv6-1.6b"])
def test_the_hook_is_the_identity_off_a_mesh_and_at_model_1(arch, monkeypatch):
    """No gather and no collective off a mesh; at model = 1 the hook
    returns each params dict itself: the launch counts of the card's
    serve phases cannot move."""
    calls = []
    monkeypatch.setattr(port_model, "gather_params",
                        lambda cfg, mesh, p, part: calls.append(part) or
                        dshard.gather_params(cfg, mesh, p, part))

    def refuse(*a, **k):
        raise AssertionError("a collective was called")

    monkeypatch.setattr(dshard, "all_gather_into", refuse)
    cfg = port_config(arch).reduced()
    params = init_params(cfg, 0, dtype=torch.float32, device="cpu")
    tokens = torch.arange(1, 9)[None]  # a multiple of the reduced SSD chunk
    want = port_model.prefill_forward(cfg, params, tokens, torch.tensor([6]),
                                      state_dtype=torch.float32)[0]
    assert calls == []
    one = Coords({"data": 1, "model": 1}, {"data": 0, "model": 0})
    with mesh_context(one):
        assert port_model._gathered(cfg, params, "top") is params
        got = port_model.prefill_forward(cfg, params, tokens, torch.tensor([6]),
                                         state_dtype=torch.float32)[0]
    assert calls and torch.equal(got, want)


# ---------------------------------------------------------------------------
# multi-rank runs
# ---------------------------------------------------------------------------


def _argv(arch: str, ckpt: Path, *extra) -> list:
    return ["--arch", arch, "--reduced", "--device", "cpu", "--steps", STEPS, "--batch", BATCH,
            "--seq", SEQ, "--ckpt-every", 2, "--ckpt-dir", ckpt, *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(arch, data, model)``: the training CLI's 4 steps at that mesh
    ((0, 0): one process), once a module; (dumps by rank, checkpoint dir)."""
    root = tmp_path_factory.mktemp("model_axis")
    done = {}

    def run(arch, data, model):
        key = (arch, data, model)
        if key not in done:
            out = root / f"{arch}-{data}x{model}"
            mesh = ["--data-model", data, model] if data else []
            world = data * model if data else 1
            run_ranks(out, world, "train", *_argv(arch, out / "ckpt", *mesh))
            done[key] = ([dict(np.load(out / f"rank{r}.npz")) for r in range(world)],
                         out / "ckpt")
        return done[key]

    return run


@functools.cache
def jax_history(arch: str, batch: int = BATCH, microbatches: int = 1):
    """JAX's jitted train step on the port's seed-0 weights and the same
    batches, at the CLI's optimizer settings: (losses, grad norms)."""
    jcfg = jax_config(arch).reduced()
    params = init_params(port_config(arch).reduced(), seed=0, dtype=torch.float32, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    opt = jax_opt.AdamWConfig(lr=3e-4, warmup_steps=STEPS, total_steps=STEPS,
                              schedule="wsd" if jcfg.wsd_schedule else "cosine")
    ts = jax_ts.TrainStepConfig(remat=True, microbatches=microbatches)
    fn = jax.jit(jax_ts.make_train_step(jcfg, opt, ts))
    js = jax_ts.init_opt_state(jcfg, jp, ts)
    losses, norms = [], []
    for step in range(STEPS):
        jp, js, m = fn(jp, js, jax_data.synthetic_batch(jcfg, batch, SEQ, step))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return np.array(losses), np.array(norms)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_training_on_a_model_axis(runs, arch, mesh):
    data, model = map(int, mesh.split("x"))
    (one,), _ = runs(arch, 0, 0)
    ranks, _ = runs(arch, data, model)
    jax_losses, jax_norms = jax_history(arch)
    cfg = port_config(arch).reduced()
    specs = _specs(cfg, data, model)
    assert len(ranks) == data * model
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["grad_norms"], jax_norms, rtol=1e-5, atol=0)
        if data == 1:  # the same rows and whole leaves: step 1's loss bit for bit
            assert got["losses"][0] == one["losses"][0]
        d, m = got["coords"]
        c = Coords({"data": data, "model": model}, {"data": int(d), "model": int(m)})
        assert (int(d), int(m)) == divmod(r, model)
        for key in one:
            if key[:2] not in ("p/", "m/", "v/"):
                continue
            path = key[2:]
            block = dshard.block_of(one[key].shape, specs[path], c)
            assert list(got[key].shape) == [hi - lo for lo, hi in block], key
            want = one[key][tuple(slice(lo, hi) for lo, hi in block)]
            np.testing.assert_allclose(got[key], want, rtol=0, atol=1e-6, err_msg=key)
    sharded = [p for p, s in specs.items() if dshard.model_dim(s) is not None]
    assert sharded and all(ranks[0][f"p/{p}"].shape != one[f"p/{p}"].shape for p in sharded)
    for r in range(model, data * model):  # the data-axis replicas, bit for bit
        for key in (k for k in ranks[r] if k[:2] in ("p/", "m/", "v/")):
            np.testing.assert_array_equal(ranks[r][key], ranks[r % model][key], err_msg=key)


@pytest.mark.parametrize("case", ["batch3", "microbatches2"])
def test_moe_capacity_on_the_data_axis_is_the_reference_batch(tmp_path, case):
    """deepseek-moe-16b at (2, 1) where the data axis does not split the
    rows as one rank's share (``--batch 3``: ``batch_shardings`` gives
    every rank the whole batch, and the capacity is its own) and with two
    microbatches (``--microbatches 2``: each cut from the global batch in
    the reference's order, its rows then split over the data axis, the
    capacity the whole microbatch's).  The reduced experts overflow their
    capacity at these batches, so a rank that sized or filled it from
    other tokens than the reference drops others: losses and grad norms
    within 1e-5 of JAX's and of the one-process run's, the params within
    1e-6, the replicas bit for bit."""
    extra = ("--batch", 3) if case == "batch3" else ("--microbatches", 2)
    run_ranks(tmp_path / "one", 1, "train", *_argv("deepseek-moe-16b", tmp_path / "c1", *extra))
    run_ranks(tmp_path / "mesh", 2, "train",
              *_argv("deepseek-moe-16b", tmp_path / "c2", *extra, "--data-model", 2, 1))
    one = np.load(tmp_path / "one" / "rank0.npz")
    jax_losses, jax_norms = jax_history("deepseek-moe-16b", *((3, 1) if case == "batch3"
                                                               else (BATCH, 2)))
    np.testing.assert_allclose(one["losses"], jax_losses, rtol=1e-5, atol=0)
    ranks = [np.load(tmp_path / "mesh" / f"rank{r}.npz") for r in range(2)]
    for got in ranks:
        np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["grad_norms"], jax_norms, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5, atol=0)
        for key in (k for k in one.files if k[:2] in ("p/", "m/", "v/")):
            np.testing.assert_allclose(got[key], one[key], rtol=0, atol=1e-6, err_msg=key)
    for key in (k for k in one.files if k[:2] in ("p/", "m/", "v/")):
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key], err_msg=key)


@pytest.mark.parametrize("compression", ["bf16", "int8_ef"])
def test_compressed_gradients_on_a_model_axis(tmp_path, compression):
    """Gradient compression on the blocks at (1, 2): bf16 rounds each
    entry as the whole leaf's would be; int8 takes its scale from the
    whole leaf's max (a max over the model group), so the run matches the
    one-process one as uncompressed training does."""
    extra = ("--grad-compression", compression)
    run_ranks(tmp_path / "one", 1, "train", *_argv("gemma-2b", tmp_path / "c1", *extra))
    run_ranks(tmp_path / "mesh", 2, "train",
              *_argv("gemma-2b", tmp_path / "c2", *extra, "--data-model", 1, 2))
    one = np.load(tmp_path / "one" / "rank0.npz")
    specs = _specs(port_config("gemma-2b").reduced(), 1, 2)
    for r in range(2):
        got = np.load(tmp_path / "mesh" / f"rank{r}.npz")
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"], rtol=1e-5, atol=0)
        c = Coords({"data": 1, "model": 2}, {"data": 0, "model": r})
        for key in (k for k in one.files if k.startswith("p/")):
            block = dshard.block_of(one[key].shape, specs[key[2:]], c)
            want = one[key][tuple(slice(lo, hi) for lo, hi in block)]
            np.testing.assert_allclose(got[key], want, rtol=0, atol=1e-6, err_msg=key)


def _sharded_count(tree: dict) -> int:
    return sum(dshard.model_dim(s) is not None for _, s in _paths(tree))


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-2.7b"])
def test_the_remat_recompute_gathers_again(tmp_path, arch):
    """The loss on the blocks at (1, 2) under the mesh context, its
    backward outside it.  With remat each layer's (hybrid: each group's
    layers' and shared block's) gathers run again in the backward; a
    recompute that skipped them would fail on the blocks' shapes and miss
    the count.  Without remat the backward gathers nothing; both give the
    same loss and gradients bit for bit."""
    run_ranks(tmp_path, 2, "remat", arch)
    cfg = port_config(arch).reduced()
    sh = param_shardings(cfg, {"data": 1, "model": 2})
    top = _sharded_count({k: v for k, v in sh.items() if k not in ("layers", "shared")})
    per_forward = cfg.n_layers * _sharded_count(sh["layers"])
    if cfg.family == "hybrid":
        per_forward += (cfg.n_layers // cfg.hybrid_attn_every) * _sharded_count(sh["shared"])
    assert per_forward > 0
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["remat_forward"] == got["plain_forward"] == top + per_forward
        assert got["remat_backward"] == per_forward
        assert got["plain_backward"] == 0
        assert got["remat_loss"] == got["plain_loss"]
        a, b = np.load(tmp_path / f"rank{r}_remat.npz"), np.load(tmp_path / f"rank{r}_plain.npz")
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _joined(ranks: list, prefix: str, cfg, data: int, model: int) -> dict:
    """The whole leaves of a run, its ranks' blocks put together."""
    specs = _specs(cfg, data, model)
    out = {}
    for key in ranks[0]:
        if not key.startswith(prefix):
            continue
        path = key[len(prefix):]
        shape = list(ranks[0][key].shape)
        d = dshard.model_dim(specs[path])
        if d is not None:
            shape[d] *= model
        whole = np.empty(shape, ranks[0][key].dtype)
        for got in ranks:
            c = Coords({"data": data, "model": model},
                       {"data": int(got["coords"][0]), "model": int(got["coords"][1])})
            block = dshard.block_of(shape, specs[path], c)
            whole[tuple(slice(lo, hi) for lo, hi in block)] = got[key]
        out[path] = whole
    return out


def test_a_model_axis_checkpoint_reads_whole_in_the_port_and_in_jax(runs):
    """Saved at (1, 2): whole leaves in contiguous segments, which the
    meshless port and the JAX package read equal, bit for bit, to the
    ranks' final blocks joined."""
    cfg = port_config("gemma-2b").reduced()
    ranks, ckpt = runs("gemma-2b", 1, 2)
    assert CheckpointManager(ckpt).list_steps() == [2, STEPS]
    manifest = json.loads((ckpt / f"step-{STEPS:08d}" / "manifest.json").read_text())
    for entry in manifest["trees"]["params"].values():
        (seg,) = entry["segments"]
        assert seg["index"] == [[0, n] for n in entry["shape"]]
    step, port, _ = CheckpointManager(ckpt).restore(device="cpu")
    jstep, jtrees, _ = jax_ckpt.CheckpointManager(ckpt).restore()
    assert step == jstep == STEPS
    for tree, prefix in (("params", "p/"), ("m", "m/"), ("v", "v/")):
        want = _joined(ranks, prefix, cfg, 1, 2)
        got_port = port["params"] if tree == "params" else port["opt_state"][tree]
        got_jax = jtrees["params"] if tree == "params" else jtrees["opt_state"][tree]
        for path, w in want.items():
            np.testing.assert_array_equal(dict(_paths(got_port))[path].numpy(), w, err_msg=path)
            np.testing.assert_array_equal(np.asarray(dict(_paths(got_jax))[path]), w,
                                          err_msg=path)
    assert int(port["opt_state"]["step"]) == STEPS


def _cut_after_step_2(ckpt: Path, dest: Path) -> Path:
    """A copy of a run's checkpoints as if it had been cut after step 2."""
    shutil.copytree(ckpt, dest)
    shutil.rmtree(dest / f"step-{STEPS:08d}")
    return dest


@pytest.mark.parametrize("shapes", ["1x2->1x2", "1x2->1x1", "1x1->2x2"])
def test_resume_across_mesh_shapes(runs, tmp_path, shapes):
    """A run cut after its step-2 checkpoint, resumed on a mesh of the
    same or another shape ("1x1": one process): steps 2 and 3 give the
    uninterrupted run's losses within 1e-5, and each rank holds the blocks
    of its mesh."""
    saved, resumed = ([int(n) for n in s.split("x")] for s in shapes.split("->"))
    src = (0, 0) if saved == [1, 1] else tuple(saved)
    base, ckpt = runs("gemma-2b", *src)
    cut = _cut_after_step_2(ckpt, tmp_path / "ckpt")
    mesh = [] if resumed == [1, 1] else ["--data-model", *resumed]
    world = resumed[0] * resumed[1]
    run_ranks(tmp_path, world, "train", *_argv("gemma-2b", cut, *mesh, "--resume"))
    cfg = port_config("gemma-2b").reduced()
    specs = _specs(cfg, *resumed)
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(got["losses"], base[0]["losses"][2:], rtol=1e-5, atol=0)
        c = Coords({"data": resumed[0], "model": resumed[1]},
                   {"data": int(got["coords"][0]), "model": int(got["coords"][1])})
        for path, t in _paths(port_model.param_shapes(cfg)):
            block = dshard.block_of(t, specs[path], c)
            assert list(got[f"p/{path}"].shape) == [hi - lo for lo, hi in block], path
