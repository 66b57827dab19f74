"""The port's pRUN (``repro_torch.launch.pRUN``) on the CPU: worlds of
real processes over the port's transports.

* A worker whose body imports no framework loads neither ``torch``, nor
  ``jax``, nor the JAX package, and runs as ``repro_torch.launch.prun``.
* Gang restart: ``elastic_allreduce`` with rank 1 killed after two sends
  and ``restarts=1`` ends bitwise equal to the unfaulted replay, on
  ``file``, ``socket``, ``shm`` and ``hier`` (4 ranks on 2 virtual
  nodes), every rank in epoch 1.
* ``elastic_np``: ``elastic_reshard`` killed and relaunched 2 -> 3
  (``file``) and 3 -> 2 (``socket``) ends equal to the fixed-size
  field; and the ``ValueError``s of a bad request.
* Clean-up: the shm arena directory is removed after a crash (the
  launcher's ``/dev/shm`` directory is redirected into a private one);
  the scratch directory goes on success and stays on failure.
* ``repro_torch.Np``/``Pid`` inside ``run_spmd``, the thread transport,
  and ``slurm_script`` equal to the reference's under the rename.

Checkpointing bodies import ``repro_torch.train.checkpoint`` (torch)
and restore host tensors (``device="cpu"``).
"""

import os
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from _torch_prun import (  # noqa: E402,F401
    allreduce_state,
    isolated,
    private_tmp,
    reshard_state,
    shm_parent,
    world_env,
)
from repro_torch.comm import run_spmd  # noqa: E402
from repro_torch.launch import pRUN  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

SELFTEST = "repro_torch.launch._selftest"
CONTEXTS = {"file": "FileMPI", "socket": "SocketComm", "shm": "ShmComm", "hier": "HierComm"}


@pytest.mark.parametrize("transport", sorted(CONTEXTS))
def test_a_worker_loads_no_framework(transport, shm_parent):
    np_, kw = (4, {"nodes": 2}) if transport == "hier" else (2, {})
    res = pRUN("_torch_prun_bodies:loaded_frameworks", np_, transport=transport,
               timeout=120, env=world_env(transport, shm_parent), **kw)
    for pid, (bad, main, np_seen, pid_seen) in enumerate(res):
        assert bad == [], f"rank {pid} loaded {bad[:5]}"
        assert main == "repro_torch.launch.prun"
        assert (np_seen, pid_seen) == (np_, pid)


def test_the_unfaulted_elastic_allreduce_is_the_replay(tmp_path):
    res = pRUN(f"{SELFTEST}:elastic_allreduce", 2, transport="file", timeout=180,
               env={"PPYTHON_ELASTIC_CKPT": str(tmp_path)})
    assert res == [(allreduce_state(2), 0)] * 2


@pytest.mark.parametrize("transport", ["file", "socket", "shm", "hier"])
def test_a_gang_restart_ends_bitwise_equal(transport, tmp_path, shm_parent):
    np_, kw = (4, {"nodes": 2}) if transport == "hier" else (2, {})
    before = metrics.counter("elastic.restarts").value
    res = pRUN(f"{SELFTEST}:elastic_allreduce", np_, transport=transport, restarts=1,
               timeout=180, env=world_env(transport, shm_parent, PPYTHON_ELASTIC_CKPT=tmp_path,
                                          PPYTHON_FAULT="kill:rank=1,after_sends=2"), **kw)
    assert res == [(allreduce_state(np_), 1)] * np_
    assert metrics.counter("elastic.restarts").value == before + 1


@pytest.mark.parametrize("transport,src_np,dst_np", [("file", 2, 3), ("socket", 3, 2)])
def test_elastic_np_resizes_the_world_bitwise(transport, src_np, dst_np, tmp_path):
    res = pRUN(f"{SELFTEST}:elastic_reshard", src_np, transport=transport, restarts=1,
               elastic_np=dst_np, timeout=180,
               env={"PPYTHON_ELASTIC_CKPT": str(tmp_path),
                    "PPYTHON_FAULT": "kill:rank=1,after_sends=4"})
    assert len(res) == dst_np
    assert [(epoch, world) for _, epoch, world in res] == [(1, dst_np)] * dst_np
    assert res[0][0] == reshard_state()
    assert all(state is None for state, _, _ in res[1:])


@pytest.mark.parametrize("kw,match", [
    ({"elastic_np": 3}, "needs restarts > 0"),
    ({"elastic_np": 0, "restarts": 1}, "elastic_np must be >= 1"),
    ({"elastic_np": 3, "restarts": 1, "transport": "thread"}, "needs a process transport"),
    ({"nodes": 2, "transport": "socket"}, "transport='hier' only"),
    ({"transport": "mpi"}, "unknown transport"),
])
def test_a_bad_request_raises_before_any_launch(kw, match):
    with pytest.raises(ValueError, match=match):
        pRUN(f"{SELFTEST}:pingpong", 2, **kw)


def test_the_shm_arena_dir_is_reclaimed_after_a_crash(shm_parent, private_tmp, monkeypatch):
    """The launcher's own arena directory (``/dev/shm/ppython_shm_*``,
    redirected here into a private directory under ``/dev/shm``) is
    removed although rank 1 died; the scratch directory stays."""
    made, real = [], tempfile.mkdtemp

    def mkdtemp(suffix=None, prefix=None, dir=None):
        if dir == "/dev/shm":
            dir = str(shm_parent)
        made.append(Path(real(suffix, prefix, dir)))
        return str(made[-1])

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    with pytest.raises(RuntimeError, match="exited with code 3"):
        pRUN(f"{SELFTEST}:crash_on_rank1", 2, transport="shm", timeout=120)
    scratch, arenas = made
    assert arenas.name.startswith("ppython_shm_")
    assert arenas.parent == (shm_parent if os.path.isdir("/dev/shm") else private_tmp)
    assert not arenas.exists()
    assert scratch.parent == private_tmp and scratch.is_dir()


def test_the_scratch_dir_goes_on_success_and_stays_on_failure(private_tmp, capsys):
    def scratch_dirs():
        return set(private_tmp.glob("ppython_*"))

    assert pRUN(f"{SELFTEST}:pingpong", 2, transport="file", timeout=120)[0] == (
        sum(range(1000)) * 2.0)
    assert scratch_dirs() == set()
    with pytest.raises(RuntimeError, match="exited with code"):
        pRUN(f"{SELFTEST}:does_not_exist", 2, transport="file", timeout=120)
    kept = scratch_dirs()
    assert len(kept) == 1 and kept.pop().is_dir()
    assert "post-mortem" in capsys.readouterr().err


def test_np_and_pid_inside_run_spmd():
    assert repro_torch.Np == 1 and repro_torch.Pid == 0
    assert run_spmd(lambda: (repro_torch.Np, repro_torch.Pid), 3) == [(3, 0), (3, 1), (3, 2)]
    with pytest.raises(AttributeError, match="no attribute 'Nq'"):
        repro_torch.Nq  # noqa: B018


def test_the_thread_transport_runs_in_this_process():
    assert pRUN(f"{SELFTEST}:bcast_barrier", 3, transport="thread") == [448.0] * 3
    with pytest.raises(ValueError, match="module:function"):
        pRUN("examples/quickstart_torch.py", 2, transport="thread")


@pytest.mark.parametrize("transport,kw", [
    ("file", {"comm_dir": "/shared/ppython"}),
    ("socket", {"nodes": 2}),
    ("hier", {"comm_dir": "/shared/results", "partition": "debug"}),
])
def test_slurm_script_is_the_references_under_the_rename(transport, kw):
    from repro.launch.slurm import slurm_script as ref_script
    from repro_torch.launch.slurm import slurm_script

    for target in (f"{SELFTEST}:redistribute_field", "examples/quickstart_torch.py"):
        got = slurm_script(target, 8, transport=transport, **kw)
        want = ref_script(target, 8, transport=transport, **kw)
        assert got == want.replace(" -m repro.launch.prun ", " -m repro_torch.launch.prun ")
    assert "-m repro_torch.launch.prun" in slurm_script(f"{SELFTEST}:pingpong", 2,
                                                       transport=transport, **kw)


def test_submit_writes_the_script_without_a_scheduler(tmp_path, monkeypatch):
    from repro_torch.launch.slurm import slurm_script, submit

    monkeypatch.setenv("PATH", str(tmp_path))  # no sbatch
    text = slurm_script(f"{SELFTEST}:pingpong", 2, transport="socket")
    path = Path(submit(text, tmp_path / "job"))
    assert path == tmp_path / "job" / "ppython_job.sbatch"
    assert path.read_text() == text and os.access(path, os.X_OK)
