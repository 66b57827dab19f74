"""Hand-written Hopper kernels for the port's hot paths.

``csrc/<name>.cu`` — CUDA C++ for sm_90a, plain C interface
``<name>.py``      — ctypes wrapper (checks, launch counter ``launches``)
                     plus the kernel's plain PyTorch version
``ops.py``         — natural-shape wrappers that dispatch by device
``_build.py``      — nvcc build at first use + ctypes loader

The submodules ``rmsnorm`` and ``flash_attention`` keep their names here
(the wrapper functions are not re-exported over them), so
``repro_torch.kernels.rmsnorm.launches`` reads the counter.
"""

from .flash_attention import attention_plain
from .ops import attention, rmsnorm_op
from .rmsnorm import rmsnorm_plain

__all__ = ["attention", "rmsnorm_op", "attention_plain", "rmsnorm_plain"]
