"""The port's dry run (``repro_torch.launch.dryrun``) and GPU node script
(``repro_torch.launch.slurm``) against the JAX package's.

* Every arch × shape cell on the reference's own mesh shapes, (16, 16)
  and (2, 16, 16) given as mappings, without tracing: the counts, the
  microbatches and ``hbm_model`` (but its fit flag) equal the
  reference's ``_microbatches`` and ``analytic_memory``, and the skipped
  cells are the reference's.
* Traced FLOPs of a reduced config's train, prefill and decode cells on
  a fake world of 1 equal ``FlopCounterMode`` over a real CPU run of the
  same step, the kernels' plain versions traded for the kernels' counts.
* Collectives on a fake world of 8 at (2, 4): the model axis's gathers
  that ``dist/shard.py``'s plan implies (again in the remat recompute),
  the data axis's all-reduces, and link bytes equal to the reference's
  ``collective_link_bytes`` on HLO lines of the same calls.
* The kernels' stand-ins: a fake input gets the kernel's outputs and no
  plain-version buffer; a real CPU tensor still gets the plain version.
* The CLI in a subprocess; the import and teardown of the fake world
  (``torch.testing._internal.distributed.fake_pg`` is private: its
  behaviour is pinned here); the node script's environment through
  ``distributed_init.world_from_env``.
"""

import dataclasses
import json
import math
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.dist import memmodel as jm  # noqa: E402
from repro.launch import dryrun as jd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.launch import distributed_init as di  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.slurm import gpu_node_script  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
REF_MESHES = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


# ---------------------------------------------------------------------------
# (a) every cell against the reference, no tracing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(REF_MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_cell_record_equals_the_reference(arch, shape, mesh):
    sizes = REF_MESHES[mesh]
    got = dryrun.cell_record(arch, shape, sizes)
    jcfg = jax_config(arch)
    cell = SHAPES[shape]
    if not jd.cell_applicable(jcfg, shape):
        # the reference returns its skip record before it builds a mesh
        want = jd.lower_cell(arch, shape, multi_pod="pod" in sizes)
        assert got == want
        return
    assert got["status"] == "ok"
    dp_total = sizes["data"] * sizes.get("pod", 1)
    mb = jd._microbatches(arch, cell.batch, dp_total) if cell.kind == "train" else 1
    assert got["microbatches"] == mb
    assert got["param_count"] == jcfg.param_count()
    assert got["active_param_count"] == jcfg.active_param_count()
    assert (got["kind"], got["batch"], got["seq"], got["n_devices"]) == (
        cell.kind, cell.batch, cell.seq, math.prod(sizes.values()))
    assert got["mesh"] == ("multi" if "pod" in sizes else "single")
    want = jm.analytic_memory(jcfg, AbstractMesh(tuple(sizes.values()), tuple(sizes)),
                              cell.kind, cell.batch, cell.seq, microbatches=mb)
    hm = dict(got["hbm_model"])
    assert hm.pop("fits_h100_80gb") == (hm["total"] <= 85_017_493_504)
    want.pop("fits_v5e_16gb")
    assert hm == want


def test_microbatch_table_is_the_reference():
    assert dryrun.MICROBATCHES == jd.MICROBATCHES
    for batch in (1, 8, 256):
        for dp in (1, 16, 32, 64):
            for arch in list_archs():
                assert dryrun._microbatches(arch, batch, dp) == jd._microbatches(arch, batch, dp)


# ---------------------------------------------------------------------------
# (b) traced FLOPs equal a real CPU run's
# ---------------------------------------------------------------------------

KERNELS = ("flash_attention", "rmsnorm", "ssd_scan")  # the wrappers ``kernels.ops`` calls


def _cost_of(name, args, kwargs):
    if name == "flash_attention":
        q, k = args[0], args[1]
        return fa.cost(*q.shape[:3], k.shape[2], q.shape[3], causal=kwargs.get("causal", True),
                       softcap=kwargs.get("softcap"), dtype=q.dtype)
    if name == "rmsnorm":
        return rn.cost(*args[0].shape, args[0].dtype)
    x, bm = args[0], args[3]
    return ss.cost(*x.shape, bm.shape[-1], args[5], x.dtype)


def _real_run(monkeypatch, fn):
    """FlopCounterMode over ``fn()`` on real CPU tensors, and of that the
    part the kernels' plain versions counted and the kernels' own
    counts for the same calls."""
    from torch.utils.flop_counter import FlopCounterMode

    seen = {"plain": 0, "kernels": 0, "calls": {}}
    for name in KERNELS:
        orig = getattr(ops, name)

        def wrapped(*args, _orig=orig, _name=name, **kwargs):
            with FlopCounterMode(display=False) as inner:
                out = _orig(*args, **kwargs)
            seen["plain"] += inner.get_total_flops()
            seen["kernels"] += _cost_of(_name, args, kwargs)["flops"]
            seen["calls"][_name] = seen["calls"].get(_name, 0) + 1
            return out

        monkeypatch.setattr(ops, name, wrapped)
    with FlopCounterMode(display=False) as outer:
        fn()
    monkeypatch.undo()
    return outer.get_total_flops(), seen


def _reduced(arch):
    cfg = get_config(arch).reduced()
    if arch == "qwen2-vl-72b":  # the reduced head is narrower than the sections
        cfg = dataclasses.replace(cfg, mrope_sections=(2, 3, 3))
    return cfg


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b", "zamba2-2.7b", "rwkv6-1.6b",
                                  "qwen2-vl-72b"])
def test_traced_flops_equal_a_real_cpu_run(monkeypatch, arch, kind):
    from repro_torch.models import init_params
    from repro_torch.models.model import init_decode_state
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig, init_opt_state, make_train_step

    cfg = _reduced(arch)
    batch, seq, mb = (4, 32, 2) if kind == "train" else (4, 64, 1)
    with dryrun.fake_world(1, shape={"data": 1, "model": 1}) as mesh:
        got = dryrun.trace_cell(cfg, kind, batch, seq, mesh, microbatches=mb,
                                dtype=torch.float32)
    assert not torch.distributed.is_initialized()

    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, 0, dtype=torch.float32, device="cpu")
    inputs = {}
    for name, (shape, dt) in dryrun.input_specs(cfg, kind, batch, seq).items():
        inputs[name] = (torch.randn(shape, generator=gen).to(dt) if dt.is_floating_point
                        else torch.randint(0, min(cfg.vocab, seq), shape, generator=gen,
                                           dtype=dt))
    if kind == "train":
        ts = TrainStepConfig(microbatches=mb)
        opt_state = init_opt_state(cfg, params, ts)
        step = make_train_step(cfg, AdamWConfig(schedule="wsd" if cfg.wsd_schedule else "cosine"),
                               ts)
        total, seen = _real_run(monkeypatch, lambda: step(params, opt_state, inputs))
        assert seen["plain"] == 0 and seen["calls"] == {}  # training takes the plain versions
    elif kind == "prefill":
        step = make_prefill_step(cfg)
        with torch.no_grad():
            total, seen = _real_run(monkeypatch, lambda: step(params, inputs))
    else:
        state = init_decode_state(cfg, batch, seq, device="cpu")
        step = make_serve_step(cfg)
        with torch.no_grad():
            total, seen = _real_run(monkeypatch, lambda: step(params, state, inputs["tokens"],
                                                              inputs["pos"]))
    assert got["aten_flops"] == total - seen["plain"]
    assert sum(k["flops"] for k in got["kernels"].values()) == seen["kernels"]
    assert {k: v["calls"] for k, v in got["kernels"].items()} == seen["calls"]
    assert got["flops"] == total - seen["plain"] + seen["kernels"]
    assert got["flops"] > 0 and got["bytes"] > 0 and got["memory"]["peak_bytes"] > 0


# ---------------------------------------------------------------------------
# (c) collectives on a fake world of 8
# ---------------------------------------------------------------------------


def _n_leaves(tree) -> int:
    return sum(_n_leaves(v) if isinstance(v, dict) else 1 for v in tree.values())


@pytest.mark.parametrize("remat", [True, False])
def test_collectives_follow_the_shard_plan(remat):
    from repro_torch.dist.shard import _plan
    from repro_torch.models.model import param_shapes

    cfg = dataclasses.replace(get_config("gemma-2b").reduced(), n_layers=3)
    sizes = {"data": 2, "model": 4}
    with dryrun.fake_world(8, shape=sizes) as mesh:
        got = dryrun.trace_cell(cfg, "train", 8, 32, mesh, remat=remat)
    plan = _plan(cfg, tuple(sizes.items()))
    gathers = _n_leaves(plan["top"]) + (2 if remat else 1) * cfg.n_layers * _n_leaves(plan["layer"])
    assert gathers > 0
    by_group = got["collectives"]["count_by_group_size"]
    assert by_group["all-gather"] == {"4": gathers}
    # one gradient a leaf and the loss over the data axis; the global norm
    # of the blocks over the model axis
    assert by_group["all-reduce"] == {"2": _n_leaves(param_shapes(cfg)) + 1, "4": 1}

    # the reference's ring accounting on HLO lines of the same calls
    lines = [f"  %c{i} = u8[{size}]{{0}} {op}(u8[{size}]{{0}} %p), "
             f"replica_groups=[{8 // n},{n}]<=[8]"
             for i, (op, size, n) in enumerate(got["collective_calls"])]
    want = jd.collective_link_bytes("\n".join(lines), 8)
    assert got["collectives"]["count"] == want["count"]
    assert got["collectives"]["bytes"].keys() == want["bytes"].keys()
    for op, b in want["bytes"].items():
        assert got["collectives"]["bytes"][op] == pytest.approx(b, rel=1e-12)


# ---------------------------------------------------------------------------
# (d) the kernels' stand-ins
# ---------------------------------------------------------------------------


def _standin_cases():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 64, 8, 128, generator=g).to(torch.bfloat16)
    kv = torch.randn(2, 64, 2, 128, generator=g).to(torch.bfloat16)
    x = torch.randn(3, 40, 2048, generator=g).to(torch.bfloat16)
    w = torch.randn(2048, generator=g)
    xs = torch.randn(2, 128, 4, 16, generator=g).to(torch.bfloat16)
    dt = torch.rand(2, 128, 4, generator=g)
    a_log = torch.randn(4, generator=g)
    bm = torch.randn(2, 128, 32, generator=g).to(torch.bfloat16)
    return {
        "flash_attention": (lambda *a: ops.attention(*a, causal=True), (q, kv, kv),
                            [((2, 64, 8, 128), torch.bfloat16)]),
        "rmsnorm": (ops.rmsnorm_op, (x, w), [((3, 40, 2048), torch.bfloat16)]),
        "ssd_scan": (lambda *a: ops.ssd(*a, chunk=32, return_state=True), (xs, dt, a_log, bm, bm),
                     [((2, 128, 4, 16), torch.bfloat16), ((2, 4, 16, 32), torch.float32)]),
    }


@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm", "ssd_scan"])
def test_a_fake_input_gets_the_kernels_outputs_alone(name):
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    fn, real, outs = _standin_cases()[name]
    with FakeTensorMode() as mode:
        fakes = tuple(mode.from_tensor(t) for t in real)
        trace = dryrun._Trace()
        with ops.kernel_tally() as tally, trace:
            got = fn(*fakes)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == outs
    assert all(isinstance(t, FakeTensor) for t in got)
    # nothing but the outputs was allocated: no plain-version buffer
    unit = dryrun.ALLOC_UNIT
    assert trace.peak == sum(-(-t.numel() * t.element_size() // unit) * unit for t in got)
    assert tally[name]["calls"] == 1
    # a real CPU tensor still takes the plain version, and no stand-in
    with ops.kernel_tally() as tally:
        want = fn(*real)
    assert tally == {}
    want = want if isinstance(want, tuple) else (want,)
    assert [(tuple(t.shape), t.dtype) for t in want] == outs


def test_standin_refuses_what_the_kernel_refuses():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(1, 16, 4, 96, dtype=torch.bfloat16)  # no bf16 tile at head_dim 96
        with pytest.raises(ValueError, match="head_dim 96"):
            ops.attention(q, q, q)
        q = torch.empty(1, 4, 16, 128, dtype=torch.bfloat16).transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            ops.attention(q, q, q)
        # a strided (B, D) row block, as the last position of a prefill is,
        # reaches the kernel as dense rows
        x = torch.empty(2, 8, 64, dtype=torch.bfloat16)[:, -1]
        assert ops.rmsnorm_op(x, torch.empty(64)).shape == (2, 64)


@pytest.mark.parametrize("shape", [(2, 64, 8, 2, 128), (1, 40, 4, 4, 64)])
def test_flash_count_is_flop_counters_without_the_mask(shape):
    from torch.utils.flop_counter import FlopCounterMode

    b, s, h, kh, d = shape
    q, k = torch.randn(b, s, h, d), torch.randn(b, s, kh, d)
    with FlopCounterMode(display=False) as fc:
        fa.attention_plain(q, k, k, causal=False)
    assert fa.cost(b, s, h, kh, d, causal=False, dtype=torch.float32)["flops"] == \
        fc.get_total_flops()
    # causal: the lower triangle with its diagonal, S(S+1)/2 pairs
    assert fa.cost(b, s, h, kh, d, causal=True)["flops"] == 4 * b * h * (s * (s + 1) // 2) * d


# ---------------------------------------------------------------------------
# (e) the CLI, (f) the world
# ---------------------------------------------------------------------------


def test_cli_writes_one_full_width_record_and_a_skip(tmp_path):
    out = tmp_path / "f.jsonl"
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "gemma-2b", "--shape", "decode_32k", "--out", str(out)],
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[ok] gemma-2b × decode_32k × 32x8" in res.stdout
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["mesh_shape"] == "32x8" and rec["n_devices"] == 256
    assert rec["param_count"] == 2_506_172_416
    assert rec["cost"] == {**rec["cost_raw"], "extrapolated_from_layers": None}
    assert rec["kernels"]["rmsnorm"]["calls"] == 2 * 18 + 1
    assert rec["collectives"]["count"]["all-gather"] > 0
    assert rec["memory"]["peak_bytes"] > rec["memory"]["at_peak"]["decode_state"] > 0
    assert "1.582x" in rec["hbm_model_note"]

    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "gemma-2b", "--shape", "long_500k", "--out", str(out)],
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    skip = json.loads(out.read_text().splitlines()[-1])
    assert skip == jd.lower_cell("gemma-2b", "long_500k")


def test_import_makes_no_world_and_the_world_goes_away():
    res = subprocess.run([sys.executable, "-c",
                          "import torch.distributed as dist, repro_torch.launch.dryrun, "
                          "repro_torch.launch.slurm; print(dist.is_initialized())"],
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "False", res.stdout + res.stderr
    dist = torch.distributed
    assert not dist.is_initialized()
    with dryrun.fake_world(16, shape={"data": 2, "model": 8}) as mesh:
        # the fake backend's behaviour the dry run leans on: rank 0 of the
        # whole world, and collectives that return at once, moving nothing
        assert (dist.get_backend(), dist.get_world_size(), dist.get_rank()) == ("fake", 16, 0)
        assert tuple(mesh.shape) == (2, 8) and mesh.mesh_dim_names == ("data", "model")
        t = torch.ones(3)
        dist.all_reduce(t, group=mesh.get_group("model"))
        assert t.tolist() == [1.0, 1.0, 1.0]
        with pytest.raises(RuntimeError, match="already initialized"):
            with dryrun.fake_world(8, shape={"data": 1, "model": 8}):
                pass
    assert not dist.is_initialized()
    with dryrun.fake_world(256) as mesh:
        assert tuple(mesh.shape) == (32, 8)
    with dryrun.fake_world(512, multi_pod=True) as mesh:
        assert tuple(mesh.shape) == (2, 32, 8) and mesh.mesh_dim_names == ("pod", "data", "model")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (g) the node script
# ---------------------------------------------------------------------------


def _exe(path: Path, text: str) -> None:
    path.write_text(text)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


def test_node_script_gives_each_task_its_rank_and_card(tmp_path):
    script = gpu_node_script("repro_torch.launch.train --arch gemma-2b", nodes=4)
    assert "#SBATCH --nodes=4" in script and "#SBATCH --ntasks-per-node=8" in script
    assert "#SBATCH --gpus-per-node=8" in script
    bin_ = tmp_path / "bin"
    bin_.mkdir()
    # the scheduler's side: the job's nodes, and srun starting task 13,
    # the sixth of its node; "python" records what the task was given
    _exe(bin_ / "scontrol", "#!/bin/bash\nprintf 'node07\\nnode08\\n'\n")
    _exe(bin_ / "srun", "#!/bin/bash\nSLURM_PROCID=13 SLURM_LOCALID=5 exec \"$@\"\n")
    _exe(bin_ / "python", f"#!{sys.executable}\nimport json, os, sys\n"
                          f"json.dump({{'env': dict(os.environ), 'argv': sys.argv[1:]}}, "
                          f"open({str(tmp_path / 'task.json')!r}, 'w'))\n")
    job = tmp_path / "job.sbatch"
    job.write_text(script)
    env = dict(os.environ, PATH=f"{bin_}:{os.environ['PATH']}",
               SLURM_JOB_NODELIST="node[07-08]")
    res = subprocess.run(["bash", str(job)], env=env, capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    task = json.loads((tmp_path / "task.json").read_text())
    assert task["argv"] == ["-m", "repro_torch.launch.distributed_init",
                            "repro_torch.launch.train", "--arch", "gemma-2b"]
    assert di.world_from_env(task["env"]) == di.WorldSpec("tcp://node07:29500", 32, 13, 5)
    with pytest.raises(ValueError):
        gpu_node_script("x", nodes=0)
    assert "export REPRO_COORD=head:1234" in gpu_node_script("x", nodes=1,
                                                             coordinator="head:1234")
