"""STREAM triad: the hand-written CUDA kernel and its plain PyTorch version.

``stream_triad`` takes two tensors of one shape.  On CUDA tensors it
launches ``csrc/stream_triad.cu`` (the port of
``repro.kernels.stream_triad``'s Pallas kernel) or raises; on CPU
tensors it runs ``triad_plain``, which the CPU tests hold against the
JAX package and ``chip_smoke.py`` holds the kernel against on the card.
The kernel rounds ``s * c + b`` once (an FMA), the plain version twice,
so the two differ by up to a few units of the terms ``|b| + |s| |c|``,
not of the result, which can cancel to near 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

launches = 0  # kernel launches so far; chip_smoke.py zeroes and reads it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def triad_plain(b: torch.Tensor, c: torch.Tensor, s: float) -> torch.Tensor:
    """``b + s * c`` in the inputs' dtype (``repro.kernels.ref.triad_ref``)."""
    return b + s * c


@functools.cache
def _launcher():
    fn = _build.load("stream_triad").stream_triad_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def stream_triad(b: torch.Tensor, c: torch.Tensor, s: float) -> torch.Tensor:
    """``a = b + s * c`` elementwise over contiguous fp32 or bf16 tensors of
    one shape and dtype, on one device."""
    if b.device != c.device or b.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stream_triad: b on {b.device}, c on {c.device}")
    if b.dtype not in _DTYPES or c.dtype != b.dtype:
        raise ValueError(f"stream_triad: b {b.dtype} and c {c.dtype} must both be fp32 or bf16")
    if b.shape != c.shape:
        raise ValueError(f"stream_triad: b {tuple(b.shape)} and c {tuple(c.shape)} differ")
    if not (b.is_contiguous() and c.is_contiguous()):
        raise ValueError("stream_triad: b and c must be contiguous")
    if b.device.type == "cpu":
        return triad_plain(b, c, s)
    a = torch.empty_like(b)
    if a.numel() == 0:
        return a
    global launches
    err = _launcher()(
        b.data_ptr(), c.data_ptr(), a.data_ptr(), a.numel(), float(s),
        _DTYPES[b.dtype], torch.cuda.current_stream(b.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"stream_triad kernel launch failed: cudaError {err}")
    launches += 1
    return a
