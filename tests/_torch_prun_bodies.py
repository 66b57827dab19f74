"""SPMD bodies of the port's pRUN tests, launched as
``pRUN("_torch_prun_bodies:fn", np)`` with ``tests`` on the workers'
``PYTHONPATH``.  This module imports nothing but the standard library,
so a worker running these bodies loads only what pRUN itself loads."""

import sys


def loaded_frameworks() -> tuple:
    """The framework modules this worker has loaded (``torch``, ``jax``,
    the JAX package ``repro``), the module it runs as ``__main__``, and
    ``repro_torch.Np``/``Pid`` as the worker sees them."""
    import repro_torch

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "repro"))
    return bad, sys.modules["__main__"].__spec__.name, repro_torch.Np, repro_torch.Pid
