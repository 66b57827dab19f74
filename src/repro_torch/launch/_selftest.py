"""SPMD self-test bodies launched via ``pRUN('repro_torch.launch._selftest:fn', np)``.

These run in real subprocesses over the file-based PythonMPI — the paper's
actual transport — and return values through the pRUN result mailbox.
"""

from __future__ import annotations

import numpy as np

import repro_torch.core as pp
from repro_torch.comm import Np, Pid, get_context
from repro_torch.core import Dmap


def pingpong() -> float:
    """Rank 0 <-> rank 1 round trip; returns payload checksum on rank 0."""
    ctx = get_context()
    payload = np.arange(1000.0) * (Pid() + 1)
    if Pid() == 0:
        ctx.send(1, "ping", payload)
        back = ctx.recv(1, "pong")
        return float(back.sum())
    if Pid() == 1:
        got = ctx.recv(0, "ping")
        ctx.send(0, "pong", got * 2.0)
    return -1.0


def bcast_barrier() -> float:
    ctx = get_context()
    val = ctx.bcast(0, {"blob": np.ones(64) * 7.0} if Pid() == 0 else None)
    ctx.barrier()
    return float(val["blob"].sum())


def redistribute_field() -> list | None:
    """Corner-turn redistribution across real processes + file messages."""
    world = Np()
    src_map = Dmap([world, 1], {}, range(world))
    dst_map = Dmap([1, world], "c", range(world))
    x = pp.arange_field(9, 10, map=src_map)
    z = pp.zeros(9, 10, map=dst_map)
    z[:, :] = x
    full = pp.agg(z, root=0)
    get_context().barrier()
    return None if full is None else full.tolist()


def complex_messages() -> bool:
    """The paper's h5py pain point: complex arrays must round-trip (pickle)."""
    ctx = get_context()
    if Pid() == 0:
        z = np.exp(1j * np.linspace(0, 3, 257)).reshape(-1)
        ctx.send(1 % Np(), "cx", z)
        return True
    if Pid() == 1:
        z = ctx.recv(0, "cx")
        return bool(np.iscomplexobj(z) and z.shape == (257,))
    return True


def crash_on_rank1() -> bool:
    """Fault-injection body: rank 1 dies hard mid-run (cleanup tests)."""
    import os

    if Pid() == 1:
        os._exit(3)
    get_context().barrier()  # never completes: the launcher kills us
    return True


def elastic_allreduce() -> tuple:
    """Elastic e2e body: a loop of deterministic allgather-sums with a
    per-rank checkpoint each step.  Under ``PPYTHON_FAULT`` one rank is
    killed mid-loop; the gang restart relaunches the world, every rank
    resumes from the last step *all* ranks hold (``elastic_resume_step``),
    and deterministic replay makes the final state bitwise-equal to an
    unfaulted run's.  Returns ``(state, final_epoch)``."""
    import os

    from repro_torch.comm.context import run_epoch
    from repro_torch.train.checkpoint import CheckpointManager, elastic_resume_step

    ctx = get_context()
    mgr = CheckpointManager(
        os.path.join(os.environ["PPYTHON_ELASTIC_CKPT"], f"rank{Pid()}")
    )
    steps = 6
    state = np.zeros(8)
    start = 0
    resume = elastic_resume_step(mgr, ctx)
    if resume is not None:
        _, trees, _ = mgr.restore(step=resume, device="cpu")
        state = np.asarray(trees["state"]["x"])
        start = resume + 1
    for step in range(start, steps):
        contrib = (np.arange(8.0) + 1.0) * float((Pid() + 1) * (step + 1))
        for v in ctx.allgather(contrib, tag=("ell", step)):
            state = state + v
        mgr.save(step, {"state": {"x": state}})
    mgr.wait()
    return state.tolist(), run_epoch()


def elastic_reshard() -> tuple:
    """Elastic *resharding* e2e body: a Dmat train-state loop whose final
    value is independent of the world size.

    Each step adds a field defined purely by global index and step
    number, applied by every rank to only its owned cells — so any grid
    produces the same global array.  Steps checkpoint collectively into
    ONE shared directory (``PPYTHON_ELASTIC_CKPT``) via ``save_sharded``.
    Under ``PPYTHON_FAULT`` + ``pRUN(restarts=1, elastic_np=M)`` a rank
    is killed and the gang relaunches at a *different* world size; the
    relaunched ranks resume through ``restore_resharded`` under the new
    world's map — the on-disk shards of the old grid land on the new one
    via the FALLS intersection — and the run must finish bitwise-equal
    to an unfaulted fixed-size run.  Returns ``(global_state, epoch,
    world)`` with the state on rank 0 only."""
    import os

    from repro_torch.comm.context import run_epoch
    from repro_torch.train.checkpoint import CheckpointManager, elastic_resume_step

    ctx = get_context()
    world = Np()
    rows, cols = 13, 5
    steps = 6
    mgr = CheckpointManager(os.environ["PPYTHON_ELASTIC_CKPT"])
    m = Dmap([world, 1], {}, range(world))
    x = pp.zeros(rows, cols, map=m)
    start = 0
    resume = elastic_resume_step(mgr, ctx)
    if resume is not None:
        _, trees, _ = mgr.restore_resharded(resume, ctx, m, device="cpu")
        x = trees["state"]["x"]
        start = resume + 1
    for step in range(start, steps):
        loc = x.local_view_owned()
        if loc.size:
            r, c = np.meshgrid(
                x.owned_indices(0), x.owned_indices(1), indexing="ij"
            )
            loc += (step + 1) * (r * cols + c + 1.0)
        mgr.save_sharded(step, {"state": {"x": x}}, ctx)
    full = pp.agg(x, root=0)
    ctx.barrier()
    return (None if full is None else full.tolist()), run_epoch(), world


def ckpt_save(ckpt_dir: str, rows: str = "13", cols: str = "5") -> bool:
    """Collective sharded save of the deterministic index field (the
    cross-run half of the restore-matrix tests: a later pRUN at a
    different world size restores it via ``ckpt_restore``)."""
    from repro_torch.train.checkpoint import CheckpointManager

    ctx = get_context()
    rows, cols = int(rows), int(cols)
    m = Dmap([Np(), 1], {}, range(Np()))
    x = pp.zeros(rows, cols, map=m)
    loc = x.local_view_owned()
    if loc.size:
        r, c = np.meshgrid(x.owned_indices(0), x.owned_indices(1),
                           indexing="ij")
        loc[...] = r * cols + c + 1.0
    CheckpointManager(ckpt_dir).save_sharded(0, {"state": {"x": x}}, ctx)
    return True


def ckpt_restore(ckpt_dir: str, dist: str = "b") -> list | None:
    """Resharding restore under this (different-sized) world's map;
    returns the aggregated global array on rank 0."""
    from repro_torch.train.checkpoint import CheckpointManager

    ctx = get_context()
    m = Dmap([Np(), 1], [dist, "b"], range(Np()))
    _, trees, _ = CheckpointManager(ckpt_dir).restore_resharded(0, ctx, m, device="cpu")
    full = pp.agg(trees["state"]["x"], root=0)
    ctx.barrier()
    return None if full is None else full.tolist()


def crash_once_pingpong() -> float:
    """Elastic-restart body: rank 1 dies hard in epoch 0; the gang
    restart relaunches the world under epoch 1 (which doubles as the
    "already crashed" marker) and the pingpong completes cleanly."""
    import os

    from repro_torch.comm.context import run_epoch

    if Pid() == 1 and run_epoch() == 0:
        os._exit(17)
    return pingpong()
