"""Launchers of the port: the training CLI (``python -m
repro_torch.launch.train``, one process or a data-parallel world), the
``torch.distributed`` bootstrap (``distributed_init``), the device meshes
(``mesh``), the torch bridge's self-test (``_torch_selftest``), the dry
run on a fake world (``dryrun``) and the H100 node script (``slurm``).
pRUN and the reference's ``slurm_script`` (pPython's own transports) stay
in ``repro.launch``."""
