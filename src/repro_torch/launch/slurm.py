"""Launch script for H100 nodes under Slurm (the port's counterpart of
``repro.launch.slurm.tpu_pod_script``).

``gpu_node_script`` renders an ``sbatch`` file that starts one process a
card, 8 a node, each running ``python -m
repro_torch.launch.distributed_init TARGET``: the bootstrap reads the
world from ``REPRO_COORD`` (the first node's ``host:port``),
``REPRO_NUM_HOSTS`` (the world size: 8 a node), ``REPRO_HOST_ID`` (the
task's ``SLURM_PROCID``) and ``REPRO_LOCAL_RANK`` (its ``SLURM_LOCALID``,
the card it drives), joins NCCL and runs the target; the production mesh
(``launch/mesh.py``) then spans every card of the job.  The reference's
``slurm_script`` for pPython's own transports stays in the reference.
"""

from __future__ import annotations

import shlex

from .mesh import NODE_CARDS

__all__ = ["gpu_node_script"]

FIRST_NODE = '$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)'


def gpu_node_script(target: str, *, nodes: int, coordinator: str | None = None,
                    port: int = 29500, python: str = "python", job_name: str = "repro",
                    partition: str | None = None, time_limit: str = "01:00:00") -> str:
    """An ``sbatch`` script running ``target`` (``module:function``, a
    script path or a module, with its arguments) on ``nodes`` nodes of 8
    cards, one task a card.  ``coordinator``: the rendezvous
    ``host:port`` (default: the job's first node at ``port``)."""
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
