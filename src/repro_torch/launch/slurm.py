"""Scheduler interface of the port (paper §I/§III: gridMatlab heritage,
Slurm first).

``slurm_script`` renders an ``sbatch`` file in which every Slurm task
runs one pPython instance (``python -m repro_torch.launch.prun
module:function``, or a script), wired to the shared comm directory
(``transport="file"``), to the TCP peer mesh through a rank-0
rendezvous (``"socket"``, no shared filesystem) or to the composite
fabric (``"hier"``: ``SLURM_NODEID`` is the node fingerprint, same-node
ranks message through ``/dev/shm`` arenas); ``submit`` writes the file
and shells out to ``sbatch`` when present.  Both are the reference's
(``repro.launch.slurm``), launching the port's workers.

``gpu_node_script`` renders an ``sbatch`` file that starts one process a
card, 8 a node, each running ``python -m
repro_torch.launch.distributed_init TARGET``: the bootstrap reads the
world from ``REPRO_COORD`` (the first node's ``host:port``),
``REPRO_NUM_HOSTS`` (the world size: 8 a node), ``REPRO_HOST_ID`` (the
task's ``SLURM_PROCID``) and ``REPRO_LOCAL_RANK`` (its ``SLURM_LOCALID``,
the card it drives), joins NCCL and runs the target; the production mesh
(``launch/mesh.py``) then spans every card of the job (the port's
counterpart of ``repro.launch.slurm.tpu_pod_script``).
"""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess
from pathlib import Path

__all__ = ["gpu_node_script", "slurm_script", "submit"]

FIRST_NODE = '$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)'


def slurm_script(
    target: str,
    np_: int,
    comm_dir: str | None = None,
    *,
    transport: str = "file",
    rdzv_port: int = 29400,
    job_name: str = "ppython",
    partition: str | None = None,
    time_limit: str = "01:00:00",
    cpus_per_task: int = 1,
    nodes: int | None = None,
    python: str = "python",
) -> str:
    """Render an sbatch script running ``np_`` pPython instances.

    ``transport="file"`` (the paper's messaging) needs ``comm_dir`` on a
    filesystem every node shares.  ``transport="socket"`` needs **no
    shared filesystem at all**: the script derives the rendezvous address
    from the job's first node, every task exchanges its TCP endpoint
    through rank 0, and messages flow over the peer mesh.
    ``transport="hier"`` bootstraps like socket but each task also
    publishes its ``SLURM_NODEID`` as the node fingerprint: same-node
    ranks message through node-local ``/dev/shm`` arenas (reclaimed per
    node after the run), cross-node ranks over TCP, and the collectives
    go two-level automatically.
    """
    if transport not in ("file", "socket", "hier"):
        raise ValueError(
            f"slurm_script transport must be file|socket|hier, "
            f"got {transport!r}"
        )
    if transport == "file" and not comm_dir:
        raise ValueError("file transport needs comm_dir on a shared filesystem")
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={job_name}",
        f"#SBATCH --ntasks={np_}",
        f"#SBATCH --cpus-per-task={cpus_per_task}",
        f"#SBATCH --time={time_limit}",
    ]
    if partition:
        lines.append(f"#SBATCH --partition={partition}")
    if nodes:
        lines.append(f"#SBATCH --nodes={nodes}")
    lines += [
        "",
        f"export PPYTHON_NP={np_}",
        f"export PPYTHON_TRANSPORT={transport}",
    ]
    if transport == "file":
        lines += [
            "# one-sided file messaging needs a shared filesystem (paper §III.D)",
            f"export PPYTHON_COMM_DIR={comm_dir}",
        ]
    else:
        lines += [
            "# TCP transport: rank 0 (on the job's first node) serves the",
            "# endpoint rendezvous — no shared filesystem on any message path",
            'PPYTHON_RDZV_HOST=$(scontrol show hostnames "$SLURM_JOB_NODELIST" '
            "| head -n1)",
            f"export PPYTHON_RDZV_ADDR=${{PPYTHON_RDZV_HOST}}:{rdzv_port}",
        ]
        if comm_dir:
            lines.append(f"export PPYTHON_COMM_DIR={comm_dir}  # results only")
        if transport == "hier":
            lines += [
                "# hier: same-node ranks message through node-local shm",
                "# arenas; SLURM_NODEID rides the rendezvous as the node",
                "# fingerprint so every rank derives the same topology",
                'export PPYTHON_SHM_DIR="/dev/shm/ppython_${SLURM_JOB_ID}"',
                'export PPYTHON_SHM_NONCE="job-${SLURM_JOB_ID}"',
            ]
    per_task_env = "PPYTHON_PID=\\$SLURM_PROCID "
    if transport == "hier":
        per_task_env += "PPYTHON_NODE_ID=\\$SLURM_NODEID "
    lines += [
        "export OMP_NUM_THREADS=1  # avoid BLAS oversubscription (paper §III.F.4)",
        "export OPENBLAS_NUM_THREADS=1",
        "export MKL_NUM_THREADS=1",
        "",
        f'srun bash -c "{per_task_env}'
        + (
            f"{python} -m repro_torch.launch.prun {target}"
            if ":" in target and not os.path.exists(target)
            else f"{python} {target}"
        )
        + '"',
    ]
    if transport == "hier":
        lines += [
            "# reclaim the node-local arena directories (shared memory is",
            "# RAM — a leak would outlive the job)",
            'srun --ntasks="$SLURM_JOB_NUM_NODES" --ntasks-per-node=1 '
            'rm -rf "$PPYTHON_SHM_DIR"',
        ]
    lines.append("")
    return "\n".join(lines)


def submit(script_text: str, workdir: str | os.PathLike = ".") -> str:
    """Write the sbatch file; submit it if ``sbatch`` exists on this host.

    Returns the job id (or the script path when no scheduler is present,
    so laptop development degrades gracefully)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    script = workdir / "ppython_job.sbatch"
    script.write_text(script_text)
    script.chmod(0o755)
    if shutil.which("sbatch") is None:
        return str(script)
    out = subprocess.run(
        ["sbatch", str(script)], capture_output=True, text=True, check=True
    )
    return out.stdout.strip().split()[-1]


def gpu_node_script(target: str, *, nodes: int, coordinator: str | None = None,
                    port: int = 29500, python: str = "python", job_name: str = "repro",
                    partition: str | None = None, time_limit: str = "01:00:00") -> str:
    """An ``sbatch`` script running ``target`` (``module:function``, a
    script path or a module, with its arguments) on ``nodes`` nodes of 8
    cards, one task a card.  ``coordinator``: the rendezvous
    ``host:port`` (default: the job's first node at ``port``)."""
    from .mesh import NODE_CARDS  # here: slurm_script's users need no torch

    if nodes < 1:
        raise ValueError(f"nodes must be >= 1, got {nodes}")
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={job_name}",
        f"#SBATCH --nodes={nodes}",
        f"#SBATCH --ntasks-per-node={NODE_CARDS}",
        f"#SBATCH --gpus-per-node={NODE_CARDS}",
        f"#SBATCH --time={time_limit}",
    ]
    if partition:
        lines.append(f"#SBATCH --partition={partition}")
    lines += [
        "",
        "# rank 0 (the first task, on the job's first node) serves the store",
        f"export REPRO_COORD={coordinator or f'{FIRST_NODE}:{port}'}",
        f"export REPRO_NUM_HOSTS={NODE_CARDS * nodes}",
        "",
        "# each task: its rank in the world and the card of its node it drives",
    ]
    task = ("export REPRO_HOST_ID=$SLURM_PROCID REPRO_LOCAL_RANK=$SLURM_LOCALID; "
            f"exec {python} -m repro_torch.launch.distributed_init {target}")
    lines += [f"srun bash -c {shlex.quote(task)}", ""]
    return "\n".join(lines)
