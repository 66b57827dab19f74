"""RMSNorm: the hand-written CUDA kernel and its plain PyTorch version.

``rmsnorm`` takes (M, D) rows.  On a CUDA tensor it launches
``csrc/rmsnorm.cu`` (the port of ``repro.kernels.rmsnorm``'s Pallas
kernel) or raises; on a CPU tensor it runs ``rmsnorm_plain``, which the
CPU tests hold against the JAX package and ``chip_smoke.py`` holds the
kernel against on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

launches = 0  # kernel launches so far; chip_smoke.py zeroes and reads it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last dim, in fp32,
    returned in x's dtype (``repro.kernels.ref.rmsnorm_ref``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


@functools.cache
def _launcher():
    fn = _build.load("rmsnorm").rmsnorm_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of each row of ``x`` (M, D), fp32 or bf16, with fp32 ``w`` (D,)."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} must be (M, D), w (D,); got w {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != torch.float32:
        raise ValueError(f"rmsnorm: x {x.dtype} must be fp32 or bf16 and w fp32, got w {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    global launches
    err = _launcher()(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
        eps, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err}")
    launches += 1
    return out
