"""Launchers of the port: the training CLI (``python -m
repro_torch.launch.train``, one process or a data-parallel world), the
``torch.distributed`` bootstrap (``distributed_init``), the device meshes
(``mesh``) and the torch bridge's self-test (``_torch_selftest``).
pRUN, Slurm and the dry-run of ``repro.launch`` are not ported yet."""
