"""Launchers of the port: pRUN, pPython's SPMD launcher over every
PythonMPI transport (``prun``: ``file``, ``socket``, ``shm``, ``hier``,
``thread``; gang restart and elastic resize), the Slurm scripts
(``slurm``: pPython worlds and H100 nodes), the training CLI (``python
-m repro_torch.launch.train``, one process or a data-parallel world), the
``torch.distributed`` bootstrap (``distributed_init``), the device meshes
(``mesh``), the torch bridge's self-test (``_torch_selftest``) and the
dry run on a fake world (``dryrun``).  Importing this package loads no
``torch``."""

from .prun import pRUN, prun_worker

__all__ = ["pRUN", "prun_worker"]
