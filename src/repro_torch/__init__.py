"""PyTorch/CUDA port of ``repro``: pPython (PGAS parallel Python) and the
model and serving stack.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core``, ``comm``, ``launch``, ``configs``, ``models``,
``kernels``, ``serve``, ``train``, ``obs``) so each module's counterpart
is found by name.  It never imports ``jax`` or anything of ``repro``: the
pure-Python modules it needs (the PGAS core, PythonMPI and its
transports, pRUN, ``ModelConfig``, the configs, the scheduler, the
metrics registry and the trace) are its own copies.

pPython's layer (``core``, ``comm``, ``launch.prun``, ``obs``) is NumPy
and the standard library only: ``import repro_torch`` loads no
``torch``, so pRUN workers start fast.  The paper's program-facing
globals are module attributes::

    import repro_torch as pPython
    me  = pPython.Pid   # rank of this SPMD instance
    np_ = pPython.Np    # number of SPMD instances

Entry points of the model stack (``models.init_params``,
``serve.ContinuousBatchingEngine``, ``serve.ServeEngine``,
``weights.params_from_numpy``) run on ``cuda`` unless the caller passes
``device="cpu"``.  On a CUDA tensor the model path launches the
hand-written Hopper kernels in ``csrc/``; on a CPU tensor it takes each
kernel's plain PyTorch version.
"""

from . import comm, core
from .core import *  # noqa: F401,F403 — the pPython user surface
from .core import __all__ as _core_all

__version__ = "1.0.0"

__all__ = ["comm", "core", "Np", "Pid", *_core_all]


def __getattr__(name: str):
    # Paper §III.A: pPython.Np / pPython.Pid reflect the active SPMD context.
    if name == "Np":
        return comm.Np()
    if name == "Pid":
        return comm.Pid()
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
