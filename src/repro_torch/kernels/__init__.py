"""Hand-written Hopper kernels for the port's hot paths.

``csrc/<name>.cu`` — CUDA C++ for sm_90a, plain C interface
``<name>.py``      — ctypes wrapper (checks, launch counter ``launches``)
                     plus the kernel's plain PyTorch version
``ops.py``         — natural-shape wrappers that dispatch by device
``_build.py``      — nvcc build at first use + ctypes loader

The submodules ``rmsnorm``, ``flash_attention``, ``ssd_scan`` and
``stream_triad`` keep their names here (the wrapper functions are not
re-exported over them), so ``repro_torch.kernels.stream_triad.launches``
reads the counter.
"""

from .flash_attention import attention_plain
from .ops import attention, rmsnorm_op, ssd, triad
from .rmsnorm import rmsnorm_plain
from .ssd_scan import ssd_plain
from .stream_triad import triad_plain

__all__ = ["attention", "rmsnorm_op", "ssd", "triad", "attention_plain", "rmsnorm_plain",
           "ssd_plain", "triad_plain"]
