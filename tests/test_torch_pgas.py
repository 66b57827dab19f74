"""The port's PGAS core and the checkpoint's ``Dmat`` paths against the
reference's, on the CPU.

The geometry is ``tests/test_ckpt_reshard.py``'s: a 17 x 6 index field,
ragged over 3 ranks (rows 6, 6, 5).  A collective sharded save
(``save_sharded``) on one grid is restored (``restore_resharded``) on
another — np 1, 2, 4 to 1, 2, 4 under block, cyclic, block-cyclic and
overlapped maps, by ``direct`` mmap reads and by ``redist`` over the
transport — and must equal the field, and the reference's restore of
the reference's save, bit for bit.  The port writes the reference's
manifest and ``.npy`` bytes, and each package restores what the other
saved.  Then the edge cases (bf16, never-opened shards, the peak buffer,
a map too big for the world, replicated leaves, ``elastic_resume_step``),
FileMPI worlds of processes (``tests/_torch_pgas_worker.py``), and the
port's pRUN against the reference's on the socket, shm and hier
transports, saves crossing between the two packages' worlds both ways.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import repro.comm as jax_comm  # noqa: E402
import repro.core as jax_core  # noqa: E402
import repro_torch.comm as port_comm  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from _torch_prun import private_tmp, shm_parent, world_env, world_kwargs  # noqa: E402,F401
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ROWS, COLS = 17, 6  # 17 rows / 3 ranks -> enhanced-block 6,6,5 (ragged)

PORT = SimpleNamespace(run_spmd=port_comm.run_spmd, get_context=port_comm.get_context,
                       Dmap=port_core.Dmap, Dmat=port_core.Dmat, agg=port_core.agg,
                       ckpt=ckpt, restore_kw={"device": "cpu"})
REF = SimpleNamespace(run_spmd=jax_comm.run_spmd, get_context=jax_comm.get_context,
                      Dmap=jax_core.Dmap, Dmat=jax_core.Dmat, agg=jax_core.agg,
                      ckpt=jax_ckpt, restore_kw={})
PKGS = {"port": PORT, "ref": REF}


def field(rows=ROWS, cols=COLS, dtype=np.float64):
    return (np.arange(rows, dtype=dtype)[:, None] * cols
            + np.arange(cols, dtype=dtype)[None, :] + 1.0)


def _fill(x, cols, dtype=None):
    loc = x.local_view_owned()
    if loc.size:
        r, c = np.meshgrid(x.owned_indices(0), x.owned_indices(1), indexing="ij")
        vals = r * cols + c + 1.0
        loc[...] = vals if dtype is None else vals.astype(dtype)
    return x


def save_field(pkg, ckpt_dir, src_np, dist=None, rows=ROWS, cols=COLS, step=0,
               dtype=np.float64):
    """Collective sharded save of ``field()`` on a [src_np, 1] grid."""

    def body():
        ctx = pkg.get_context()
        x = pkg.Dmat((rows, cols), pkg.Dmap([ctx.np_, 1], dist, range(ctx.np_)),
                     dtype=dtype, ctx=ctx)
        pkg.ckpt.CheckpointManager(ckpt_dir).save_sharded(step, {"state": {"x": _fill(x, cols)}},
                                                          ctx)

    pkg.run_spmd(body, src_np)


def restore_field(pkg, ckpt_dir, dst_np, dst_map, via="auto", step=0):
    """restore_resharded on ``dst_np`` thread-ranks; returns rank 0's agg."""

    def body():
        ctx = pkg.get_context()
        m = dst_map(pkg.Dmap, ctx.np_) if callable(dst_map) else dst_map
        _, trees, _ = pkg.ckpt.CheckpointManager(ckpt_dir).restore_resharded(
            step, ctx, m, via=via, **pkg.restore_kw)
        return pkg.agg(trees["state"]["x"], root=0)

    return pkg.run_spmd(body, dst_np)[0]


DST_MAPS = {
    "block": lambda Dmap, n: Dmap([n, 1], {}, range(n)),
    "cyclic": lambda Dmap, n: Dmap([n, 1], "c", range(n)),
    "bc2-cols": lambda Dmap, n: Dmap([1, n], {"dist": "bc", "size": 2}, range(n)),
    "overlap": lambda Dmap, n: Dmap([n, 1], {}, range(n), overlap=[1, 0]),
}


# ---------------------------------------------------------------------------
# the restore matrix: the port against the reference, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("via", ["direct", "redist"])
@pytest.mark.parametrize("dst_kind", sorted(DST_MAPS))
@pytest.mark.parametrize("dst_np", [1, 2, 4])
@pytest.mark.parametrize("src_np", [1, 2, 4])
def test_reshard_matrix_equals_the_reference(tmp_path, src_np, dst_np, dst_kind, via):
    got_want = {}
    for name, pkg in PKGS.items():
        save_field(pkg, tmp_path / name, src_np)
        try:
            got_want[name] = restore_field(pkg, tmp_path / name, dst_np, DST_MAPS[dst_kind], via)
        except RuntimeError as e:
            got_want[name] = str(e)
    got, want = got_want["port"], got_want["ref"]
    if via == "redist" and src_np > dst_np:
        # the saved map's ranks must be live to read their shards
        assert isinstance(want, str) and "cannot restore" in want
        assert got == want
        return
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, field())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src_dist", ["c", {"dist": "bc", "size": 2}])
def test_cyclic_sources_reshard(tmp_path, src_dist):
    save_field(PORT, tmp_path, 2, dist=[src_dist, "b"])
    for via in ("direct", "redist"):
        np.testing.assert_array_equal(
            restore_field(PORT, tmp_path, 4, DST_MAPS["block"], via), field())


# ---------------------------------------------------------------------------
# files across packages
# ---------------------------------------------------------------------------


def _mixed_save(pkg, root, world):
    """A Dmat of each map kind and dtype, a replicated leaf (a tensor in
    the port, an array in the reference) and a 0-d step, saved on
    ``world`` thread-ranks."""

    def body():
        ctx = pkg.get_context()
        n = ctx.np_
        x = _fill(pkg.Dmat((ROWS, COLS), pkg.Dmap([n, 1], {}, range(n)), ctx=ctx), COLS)
        c = _fill(pkg.Dmat((9, 4), pkg.Dmap([n, 1], "c", range(n)), dtype=np.float32,
                           ctx=ctx), 4)
        bc = _fill(pkg.Dmat((3, 10), pkg.Dmap([1, n], {"dist": "bc", "size": 2}, range(n)),
                            dtype=np.int64, ctx=ctx), 10)
        h = _fill(pkg.Dmat((8, 4), pkg.Dmap([n, 1], {}, range(n)), dtype=ml_dtypes.bfloat16,
                           ctx=ctx), 4, ml_dtypes.bfloat16)
        rep = np.linspace(-1.0, 1.0, 7, dtype=np.float32)
        tree = {"state": {"x": x, "c": c, "bc": bc, "h": h,
                          "rep": torch.from_numpy(rep) if pkg is PORT else rep},
                "opt_state": {"step": np.int32(7)}}
        pkg.ckpt.CheckpointManager(root).save_sharded(3, tree, ctx, extra_meta={"arch": "x"})

    pkg.run_spmd(body, world)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sharded_save_writes_the_reference_bytes(tmp_path, world):
    for name, pkg in PKGS.items():
        _mixed_save(pkg, tmp_path / name, world)
    port, ref = (tmp_path / n / "step-00000003" for n in ("port", "ref"))
    texts = [re.sub(r'"time": [0-9.e+-]+', '"time": 0', (d / "manifest.json").read_text())
             for d in (port, ref)]
    assert texts[0] == texts[1]
    manifest = json.loads(texts[0])
    assert manifest["format"] == 2 and manifest["meta"] == {"arch": "x"}
    assert [s["saver"] for s in manifest["trees"]["state"]["x"]["segments"]] == list(range(world))
    files = sorted(p.name for p in ref.glob("*.npy"))
    assert files == sorted(p.name for p in port.glob("*.npy"))
    for f in files:
        assert (port / f).read_bytes() == (ref / f).read_bytes(), f


@pytest.mark.parametrize("via", ["direct", "redist"])
@pytest.mark.parametrize("saver,restorer,src_np,dst_np",
                         [("ref", "port", 2, 3), ("ref", "port", 4, 4),
                          ("port", "ref", 3, 2), ("port", "ref", 2, 4)])
def test_each_package_restores_what_the_other_saved(tmp_path, saver, restorer, src_np,
                                                    dst_np, via):
    save_field(PKGS[saver], tmp_path, src_np)
    if via == "redist" and src_np > dst_np:
        with pytest.raises(RuntimeError, match="cannot restore"):
            restore_field(PKGS[restorer], tmp_path, dst_np, DST_MAPS["cyclic"], via)
        return
    got = restore_field(PKGS[restorer], tmp_path, dst_np, DST_MAPS["cyclic"], via)
    np.testing.assert_array_equal(got, field())


@pytest.mark.parametrize("saver", ["port", "ref"])
def test_mixed_trees_restore_across_packages(tmp_path, saver):
    """Every leaf of ``_mixed_save`` on 3 ranks, restored on 2 by the
    other package: the Dmats under a cyclic map, the rest replicated."""
    _mixed_save(PKGS[saver], tmp_path, 3)
    restorer = PORT if saver == "ref" else REF

    def body():
        ctx = restorer.get_context()
        m = restorer.Dmap([ctx.np_, 1], "c", range(ctx.np_))
        _, trees, meta = restorer.ckpt.CheckpointManager(tmp_path).restore_resharded(
            3, ctx, m, **restorer.restore_kw)
        s = trees["state"]
        return ({k: restorer.agg(s[k], root=0) for k in ("x", "c", "bc", "h")},
                s["rep"], trees["opt_state"]["step"], meta)

    dm, rep, step, meta = restorer.run_spmd(body, 2)[0]
    np.testing.assert_array_equal(dm["x"], field())
    np.testing.assert_array_equal(dm["c"], field(9, 4, np.float32))
    np.testing.assert_array_equal(dm["bc"], field(3, 10).astype(np.int64))
    assert dm["h"].dtype == np.float32  # bf16 widens bit-exactly
    np.testing.assert_array_equal(dm["h"], field(8, 4).astype(ml_dtypes.bfloat16)
                                  .astype(np.float32))
    np.testing.assert_array_equal(np.asarray(rep), np.linspace(-1.0, 1.0, 7, dtype=np.float32))
    assert int(step) == 7 and meta == {"arch": "x"}


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------


def test_bf16_dmat_widens_bit_exactly(tmp_path):
    save_field(PORT, tmp_path, 2, rows=8, cols=4, dtype=ml_dtypes.bfloat16)
    entry = json.loads((tmp_path / "step-00000000" / "manifest.json").read_text())
    assert entry["trees"]["state"]["x"]["dtype"] == "bfloat16"
    want = field(8, 4).astype(ml_dtypes.bfloat16).astype(np.float32)
    for via in ("direct", "redist"):
        got = restore_field(PORT, tmp_path, 3, DST_MAPS["cyclic"], via)
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_zero_intersection_shards_are_never_opened(tmp_path):
    save_field(PORT, tmp_path, 3)
    opened = metrics.counter("ckpt.files_opened")
    before = opened.value
    got = restore_field(PORT, tmp_path, 3, DST_MAPS["block"], "direct")
    assert opened.value - before == 3  # each rank its own shard alone
    np.testing.assert_array_equal(got, field())
    # delete the shards rank 0's rows do not touch: a one-rank window of
    # them still reads
    step_dir = tmp_path / "step-00000000"
    entry = json.loads((step_dir / "manifest.json").read_text())["trees"]["state"]["x"]
    for seg in entry["segments"][1:]:
        (step_dir / seg["file"]).unlink()
    before = opened.value
    np.testing.assert_array_equal(ckpt.reshard_read(step_dir, entry, [[0, 6], [0, COLS]]),
                                  field()[:6])
    assert opened.value - before == 1


@pytest.mark.parametrize("via", ["direct", "redist"])
def test_no_rank_holds_more_than_its_part(tmp_path, via):
    save_field(PORT, tmp_path, 2, rows=64, cols=32)
    peak = metrics.gauge("ckpt.peak_buffer_bytes")
    peak.set(0)
    got = restore_field(PORT, tmp_path, 4, DST_MAPS["block"], via)
    np.testing.assert_array_equal(got, field(64, 32))
    dst_part, src_part = 16 * 32 * 8, 32 * 32 * 8
    # direct: the owned part alone; redist: that, or a saved rank's part
    assert peak.value == (dst_part if via == "direct" else src_part)
    assert peak.value < field(64, 32).nbytes


def test_a_destination_map_too_big_for_the_world_raises(tmp_path):
    save_field(PORT, tmp_path, 2)
    with pytest.raises(RuntimeError, match="does not fit the live world"):
        restore_field(PORT, tmp_path, 2, port_core.Dmap([4, 1], {}, range(4)))


@pytest.mark.parametrize("via", ["direct", "redist"])
def test_a_replicated_leaf_is_written_once_and_restores_as_a_tensor(tmp_path, via):
    def save():
        ctx = port_comm.get_context()
        x = port_core.Dmat((4, 4), port_core.Dmap([ctx.np_, 1], {}, range(ctx.np_)), ctx=ctx)
        x.local_view_owned()[...] = 1.0
        ckpt.CheckpointManager(tmp_path).save_sharded(
            0, {"state": {"x": x, "rng": torch.arange(5.0)}}, ctx)

    port_comm.run_spmd(save, 2)
    entry = json.loads((tmp_path / "step-00000000" / "manifest.json").read_text())
    rng = entry["trees"]["state"]["rng"]
    assert len(rng["segments"]) == 1 and "dmap" not in rng
    assert rng["segments"][0]["file"] == "state__rng__s0.npy"

    def restore():
        ctx = port_comm.get_context()
        m = port_core.Dmap([ctx.np_, 1], "c", range(ctx.np_))
        _, trees, _ = ckpt.CheckpointManager(tmp_path).restore_resharded(
            0, ctx, m, via=via, device="cpu")
        t = trees["state"]["rng"]
        t.add_(0.0)  # writable on every rank
        return t

    for t in port_comm.run_spmd(restore, 3):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert torch.equal(t, torch.arange(5.0))


def test_restore_resharded_asks_for_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    save_field(PORT, tmp_path, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.CheckpointManager(tmp_path).restore_resharded(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore_resharded(ckpt.CheckpointManager(tmp_path), 0)


def test_single_process_restore_of_a_sharded_save(tmp_path):
    """Saved on 2 ranks, restored with no ctx: the saved map does not fit
    np = 1, so the leaf replicates, a tensor read whole."""
    save_field(PORT, tmp_path, 2)
    step, trees, _ = ckpt.restore_resharded(ckpt.CheckpointManager(tmp_path), device="cpu")
    assert step == 0
    np.testing.assert_array_equal(trees["state"]["x"].numpy(), field())
    _, trees, _ = ckpt.CheckpointManager(tmp_path).restore(device="cpu")
    np.testing.assert_array_equal(trees["state"]["x"].numpy(), field())


def test_elastic_resume_step_is_the_minimum_over_ranks(tmp_path):
    """Per-rank roots; rank 1's lacks the latest step (3), so the world
    resumes from 2; a rank with no checkpoint at all gives None."""
    for r in range(3):
        mgr = ckpt.CheckpointManager(tmp_path / f"r{r}")
        for s in (1, 2) if r == 1 else (1, 2, 3):
            mgr.save(s, {"state": {"w": np.full(3, float(s))}})
    ckpt.CheckpointManager(tmp_path / "empty")

    def body(root_of):
        ctx = port_comm.get_context()
        return ckpt.elastic_resume_step(ckpt.CheckpointManager(root_of(ctx.pid)), ctx)

    assert port_comm.run_spmd(lambda: body(lambda p: tmp_path / f"r{p}"), 3) == [2, 2, 2]
    assert port_comm.run_spmd(
        lambda: body(lambda p: tmp_path / ("empty" if p == 2 else f"r{p}")), 3) == [None] * 3
    assert ckpt.elastic_resume_step(ckpt.CheckpointManager(tmp_path / "r0")) == 3


def test_resume_step_then_resharded_restore_on_a_larger_world(tmp_path):
    save_field(PORT, tmp_path, 2, step=0)
    save_field(PORT, tmp_path, 2, step=3)

    def body():
        ctx = port_comm.get_context()
        mgr = ckpt.CheckpointManager(tmp_path)
        resume = ckpt.elastic_resume_step(mgr, ctx)
        m = port_core.Dmap([ctx.np_, 1], "c", range(ctx.np_))
        _, trees, _ = ckpt.restore_resharded(mgr, resume, ctx, m, device="cpu")
        return resume, port_core.agg(trees["state"]["x"], root=0)

    res = port_comm.run_spmd(body, 4)
    assert all(r[0] == 3 for r in res)
    np.testing.assert_array_equal(res[0][1], field())


# ---------------------------------------------------------------------------
# a FileMPI world of processes
# ---------------------------------------------------------------------------


def _file_world(tmp_path, tag, world, *args):
    """``tests/_torch_pgas_worker.py ARGS`` on ``world`` processes over a
    fresh FileMPI directory; every rank must exit 0."""
    comm = tmp_path / f"comm-{tag}"
    comm.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), PPYTHON_TRANSPORT="file",
               PPYTHON_NP=str(world), PPYTHON_COMM_DIR=str(comm), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "_torch_pgas_worker.py"),
                               *map(str, args)],
                              env=dict(env, PPYTHON_PID=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"


@pytest.mark.parametrize("via", ["auto", "redist"])
def test_file_world_save_np2_restore_np4(tmp_path, via):
    ck, out = tmp_path / "ckpt", tmp_path / "full.npy"
    _file_world(tmp_path, "save", 2, "save", ck, 13, 5)
    _file_world(tmp_path, "restore", 4, "restore", ck, "c", out, via)
    np.testing.assert_array_equal(np.load(out), field(13, 5))


def test_file_world_restores_a_reference_prun_save(tmp_path, private_tmp):
    from repro.launch import pRUN

    ck, out = tmp_path / "ckpt", tmp_path / "full.npy"
    pRUN("repro.launch._selftest:ckpt_save", 2, args=(str(ck),), transport="file",
         timeout=120)
    _file_world(tmp_path, "restore", 3, "restore", ck, "b", out)
    np.testing.assert_array_equal(np.load(out), field(13, 5))


# ---------------------------------------------------------------------------
# the process transports: the port's pRUN against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["socket", "shm", "hier"])
def test_port_prun_worlds_equal_the_reference_pruns(transport, shm_parent):
    """``redistribute_field`` (a corner turn of the 9 x 10 arange field)
    on a world of the port's pRUN equals the reference pRUN's world on
    the same transport (hier: 4 ranks on 2 virtual nodes)."""
    from repro.launch import pRUN as ref_pRUN
    from repro_torch.launch import pRUN

    kw = world_kwargs(transport)
    want = ref_pRUN("repro.launch._selftest:redistribute_field", transport=transport,
                    timeout=120, env=world_env(transport, shm_parent), **kw)
    got = pRUN("repro_torch.launch._selftest:redistribute_field", transport=transport,
               timeout=120, env=world_env(transport, shm_parent), **kw)
    assert got == want
    assert got[0] == np.arange(90.0).reshape(9, 10).tolist()
    assert got[1:] == [None] * (kw["np_"] - 1)


def test_a_reference_world_restores_a_port_prun_save(tmp_path, private_tmp):
    from repro.launch import pRUN as ref_pRUN
    from repro_torch.launch import pRUN

    ck = tmp_path / "ckpt"
    assert pRUN("repro_torch.launch._selftest:ckpt_save", 2, args=(str(ck),),
                transport="file", timeout=120) == [True, True]
    got = ref_pRUN("repro.launch._selftest:ckpt_restore", 3, args=(str(ck), "c"),
                   transport="file", timeout=120)
    np.testing.assert_array_equal(np.asarray(got[0]), field(13, 5))


def test_the_file_transport_is_the_default_of_init(monkeypatch, tmp_path):
    monkeypatch.delenv("PPYTHON_TRANSPORT", raising=False)
    monkeypatch.setenv("PPYTHON_NP", "2")
    monkeypatch.setenv("PPYTHON_PID", "1")
    monkeypatch.setenv("PPYTHON_COMM_DIR", str(tmp_path))
    ctx = port_comm.init()
    try:
        assert isinstance(ctx, port_comm.FileMPI) and (ctx.np_, ctx.pid) == (2, 1)
    finally:
        ctx.finalize()
        port_comm.context._global_ctx = None
