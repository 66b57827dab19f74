"""Launchers of the port: the training CLI (``python -m
repro_torch.launch.train``).  pRUN, Slurm and the mesh launchers of
``repro.launch`` wait for distribution."""
