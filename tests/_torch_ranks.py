"""Runs of ``tests/_torch_model_axis_worker.py`` over a gloo world, for
the port's multi-rank tests: N subprocesses of ``python -m
repro_torch.launch.distributed_init --device cpu`` (one thread each)
meeting at a ``FileStore`` under the caller's directory, never a fixed
port."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_model_axis_worker.py"


def run_ranks(out: Path, world: int, mode: str, *args, timeout: int = 240,
              ok: bool = True) -> list[str]:
    """The worker's ``mode`` over ``world`` gloo ranks (one thread each);
    returns each rank's log.  ``ok``: every rank must exit 0."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO / 'tests'}",
               REPRO_NUM_HOSTS=str(world), REPRO_COORD=f"file://{out / 'store'}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.distributed_init", "--device", "cpu",
         str(WORKER), mode, str(out), *map(str, args)],
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
    if ok:
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return logs
