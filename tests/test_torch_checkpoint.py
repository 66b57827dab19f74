"""The port's checkpoints against the JAX package's: a checkpoint saved by
either restores bit for bit in the other (fp32 and bf16 leaves, the 0-d
int32 step; the port's files and manifest are the reference's), a
format-2 manifest of FALLS segments from the reference's collective
sharded save restores in the port, and the manager's retention, atomic
publish, torn-step discovery and ``reshard_read`` windows behave as the
reference's (``tests/test_train.py``, ``tests/test_ckpt_reshard.py``).
The ``Dmat`` paths are held to the reference in ``tests/test_torch_pgas.py``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.comm import get_context, run_spmd  # noqa: E402
from repro.core import Dmap  # noqa: E402
from repro.core.dmat import Dmat  # noqa: E402
from repro.core.pitfalls import block_falls  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402


def _bf16_bits(rng, shape):
    """Finite bf16 values as their uint16 bits (fp32 draws, truncated)."""
    return (rng.standard_normal(shape).astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)


def _arrays(seed=0):
    """fp32, bf16 (as uint16 bits) and int32 leaves, nested, as NumPy."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "embed": rng.standard_normal((8, 6)).astype(np.float32),
            "layers": {"w": rng.standard_normal((3, 4, 5)).astype(np.float32),
                       "wb": _bf16_bits(rng, (4, 6))},
        },
        "opt_state": {"step": np.int32(7), "m": {"embed": rng.standard_normal(8).astype(np.float32)}},
    }


def _as_torch(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _as_torch(v)
        elif v.dtype == np.uint16:  # bf16 bits
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _as_jax(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _as_jax(v)
        elif v.dtype == np.uint16:
            out[k] = jnp.asarray(v.view(jnp.bfloat16))
        else:
            out[k] = jnp.asarray(v)
    return out


def _bits(x):
    """A leaf of either package (or NumPy) as comparable NumPy bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16), "bfloat16"
    return x, x.dtype.name


def _assert_trees_bitwise(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_bitwise(got[k], want[k], f"{path}/{k}")
            continue
        (g, gd), (w, wd) = _bits(got[k]), _bits(want[k])
        assert gd == wd and g.shape == w.shape, f"{path}/{k}: {gd}{g.shape} vs {wd}{w.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


def _manifest(root, step):
    with open(root / f"step-{step:08d}" / "manifest.json") as f:
        m = json.load(f)
    del m["time"]
    return m


@pytest.mark.parametrize("blocking", [True, False], ids=["blocking", "async"])
def test_a_jax_checkpoint_restores_in_the_port_bitwise(tmp_path, blocking):
    arrays = _arrays(1)
    mgr = jax_ckpt.CheckpointManager(tmp_path)
    mgr.save(7, _as_jax(arrays), blocking=blocking, extra_meta={"arch": "x"})
    mgr.wait()
    step, trees, meta = ckpt.CheckpointManager(tmp_path).restore(device="cpu")
    assert step == 7 and meta == {"arch": "x"}
    assert trees["opt_state"]["step"].dim() == 0
    assert trees["params"]["layers"]["wb"].dtype == torch.bfloat16
    _assert_trees_bitwise(trees, _as_torch(arrays))


@pytest.mark.parametrize("blocking", [True, False], ids=["blocking", "async"])
def test_a_port_checkpoint_restores_in_jax_bitwise(tmp_path, blocking):
    """The port writes the reference's files and manifest: the same
    bytes, and JAX restores them bit for bit."""
    arrays = _arrays(2)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    mgr = ckpt.CheckpointManager(port_dir)
    trees = _as_torch(arrays)
    mgr.save(3, trees, blocking=blocking)
    if not blocking:  # the snapshot was taken before save returned
        trees["params"]["embed"].add_(1.0)
    mgr.wait()
    jax_ckpt.CheckpointManager(jax_dir).save(3, _as_jax(arrays))
    assert _manifest(port_dir, 3) == _manifest(jax_dir, 3)
    for f in (jax_dir / "step-00000003").glob("*.npy"):
        assert (port_dir / "step-00000003" / f.name).read_bytes() == f.read_bytes(), f.name
    step, got, _ = jax_ckpt.CheckpointManager(port_dir).restore()
    assert step == 3
    _assert_trees_bitwise(got, _as_jax(arrays))


def test_format2_falls_segments_restore_in_the_port(tmp_path):
    """A cyclic 17 x 6 field saved by the reference's collective sharded
    save on 3 thread-ranks (a format-2 manifest, one FALLS segment a
    rank) restores whole in the port, and windows of it read exactly."""
    rows, cols = 17, 6
    field = np.arange(rows * cols, dtype=np.float64).reshape(rows, cols) + 1.0

    def body():
        ctx = get_context()
        m = Dmap([ctx.np_, 1], {0: "c"}, range(ctx.np_))
        x = Dmat((rows, cols), m, ctx=ctx)
        loc = x.local_view_owned()
        r, c = np.meshgrid(x.owned_indices(0), x.owned_indices(1), indexing="ij")
        loc[...] = field[r, c]
        jax_ckpt.CheckpointManager(tmp_path).save_sharded(0, {"state": {"x": x}}, ctx)

    run_spmd(body, 3)
    manifest = _manifest(tmp_path, 0)
    assert manifest["format"] == 2
    entry = manifest["trees"]["state"]["x"]
    assert all("falls" in s for s in entry["segments"])
    _, trees, _ = ckpt.CheckpointManager(tmp_path).restore(device="cpu")
    np.testing.assert_array_equal(trees["state"]["x"].numpy(), field)
    step_dir = tmp_path / "step-00000000"
    for want in ([[2, 11], [1, 5]], [[16, 17], [0, 6]], [[0, 0], [0, 6]]):
        (r0, r1), (c0, c1) = want
        np.testing.assert_array_equal(ckpt.reshard_read(step_dir, entry, want),
                                      field[r0:r1, c0:c1])


def test_reshard_read_windows(tmp_path):
    """Segments of 3 saver ranks (rows 6, 6, 5) read as the windows of 5
    reader ranks; a bf16 leaf's windows come back widened bit for bit."""
    full = np.arange(17 * 4, dtype=np.float32).reshape(17, 4)
    bits = _bf16_bits(np.random.default_rng(3), (17, 4))
    bits[0, :2] = (0x7FC1, 0xFF81)  # NaNs with payloads: the port keeps their bits
    step_dir = tmp_path / "step-00000001"
    step_dir.mkdir()
    entries = {}
    for name, arr, dtype in (("w", full, "float32"), ("wb", bits, "bfloat16")):
        segs = []
        for r in range(3):
            f = block_falls(17, 3, r)[0]
            fn = f"params__{name}__s{r}.npy"
            np.save(step_dir / fn, arr[f.l:f.r + 1])
            segs.append({"file": fn, "index": [[f.l, f.r + 1], [0, 4]]})
        entries[name] = {"shape": [17, 4], "dtype": dtype, "segments": segs}
    widened = (bits.astype(np.uint32) << 16).view(np.float32)
    for r in range(5):
        f = block_falls(17, 5, r)[0]
        want = [[f.l, f.r + 1], [1, 3]]
        np.testing.assert_array_equal(ckpt.reshard_read(step_dir, entries["w"], want),
                                      full[f.l:f.r + 1, 1:3])
        np.testing.assert_array_equal(ckpt.reshard_read(step_dir, entries["wb"], want),
                                      widened[f.l:f.r + 1, 1:3])
    tree = ckpt.load_tree(step_dir, "params", entries, device="cpu")
    assert tree["wb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["wb"].view(torch.int16).numpy().view(np.uint16), bits)


def test_retention_atomic_publish_and_torn_steps(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, _as_torch(_arrays(s)))
    assert mgr.list_steps() == [2, 3]
    assert not list(tmp_path.glob("*.tmp"))
    # a step torn by a crash (a shard cut short) is skipped by discovery;
    # an explicit restore of it still reads (and fails loudly on) the file
    shard = next((tmp_path / "step-00000003").glob("params__embed__s0.npy"))
    shard.write_bytes(shard.read_bytes()[:-8])
    assert mgr.list_steps(valid_only=True) == [2] and mgr.latest_step() == 2
    step, trees, _ = mgr.restore(device="cpu")
    assert step == 2
    _assert_trees_bitwise(trees, _as_torch(_arrays(2)))
    with pytest.raises(ValueError):
        mgr.restore(3, device="cpu")
    # an unpublished .tmp directory is invisible
    (tmp_path / "step-00000009.tmp").mkdir()
    assert mgr.list_steps() == [2, 3]


def test_restore_without_a_checkpoint_or_a_card_raises(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore(device="cpu")
    if not torch.cuda.is_available():
        mgr.save(1, _as_torch(_arrays()))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.restore()

