"""Distribution helpers of the port (the port of ``repro.dist``).

``repro_torch.core`` keeps the paper's NumPy map construct; this package
translates its mapping ideas into ``torch.distributed``:

* ``hints``    — ``constrain``/``mesh_context`` (identity with no mesh and
                 on local tensors; ``DTensor.redistribute`` on a DTensor).
* ``sharding`` — Dmap → per-dim specs and ``Shard``/``Replicate``
                 placements for params, optimizer state, batches and
                 decode state, built from mesh sizes and names alone.
* ``memmodel`` — the analytic per-device memory model on the same trees.

Only ``hints`` is re-exported, as in the reference.
"""

from .hints import constrain, current_mesh, mesh_context

__all__ = ["constrain", "current_mesh", "mesh_context"]
