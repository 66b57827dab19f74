"""RMSNorm: the hand-written CUDA kernel and its plain PyTorch version.

``rmsnorm`` takes (M, D) rows and a weight of D values, or of G rows of
D values that rows r take as w[r mod G] (a norm by groups: the rows of
a (..., G, D) tensor).  On a CUDA tensor it launches
``csrc/rmsnorm.cu`` (the port of ``repro.kernels.rmsnorm``'s Pallas
kernel) or raises; on a CPU tensor it runs ``rmsnorm_plain``, which the
CPU tests hold against the JAX package and ``chip_smoke.py`` holds the
kernel against on the card.  The kernel has no backward: with grad
enabled, an input off the CPU that requires grad raises.

``layout`` reports the kernel's layout for a width (it depends on D and
the dtype, never on M), and ``floor_launch`` launches an empty kernel of
a given grid, the yardstick ``chip_smoke.py`` times beside each row.
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
    returned in x's dtype (``repro.kernels.ref.rmsnorm_ref``); a (G, D)
    ``w`` scales the rows of x in turn, row r by w[r mod G]."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    if w.dim() == 2:
        y = (xf * torch.rsqrt(var + eps)).reshape(-1, *w.shape) * (1.0 + w.float())
        return y.reshape(x.shape).to(x.dtype)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def cost(m: int, d: int, dtype=torch.bfloat16, groups: int = 1) -> dict:
    """One call's work on (m, d) rows, counted as ``PERF.md``'s bound
    counts it: x read and y written once, w (fp32, ``groups`` rows) read
    once; 4 operations an element, one rsqrt a row.  No matrix product: 0
    ``flops`` in ``FlopCounterMode``'s sense, which counts none for the
    plain version either."""
    e = torch.finfo(dtype).bits // 8
    return {"flops": 0, "operations": 4 * m * d, "bytes": 2 * m * d * e + 4 * d * groups,
            "transcendentals": m}


def check_inputs(x, w):
    """The kernel's refusals that shapes, dtypes and strides decide."""
    rows = w.dim() == 1 or (w.dim() == 2 and w.shape[0] > 0 and x.shape[0] % w.shape[0] == 0)
    if x.dim() != 2 or w.shape[-1:] != x.shape[1:] or not rows:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} must be (M, D), w (D,) or (G, D) with G "
                         f"dividing M; got w {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != torch.float32:
        raise ValueError(f"rmsnorm: x {x.dtype} must be fp32 or bf16 and w fp32, got w {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")


@functools.cache
def _lib():
    lib = _build.load("rmsnorm")
    lib.rmsnorm_grouped_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.rmsnorm_layout.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.rmsnorm_floor_launch.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.rmsnorm_grouped_launch, lib.rmsnorm_layout, lib.rmsnorm_floor_launch):
        fn.restype = ctypes.c_int
    return lib


def layout(d: int, dtype: torch.dtype) -> dict:
    """The kernel's layout for rows of ``d`` elements of ``dtype`` on
    16-byte-aligned pointers, one block a row: threads a row and 16-byte
    vectors a thread (0 on the scalar path).  Builds the kernel."""
    out = (ctypes.c_int * 2)()
    if _lib().rmsnorm_layout(d, _DTYPES[dtype], out):
        raise ValueError(f"rmsnorm: no layout for d {d}")
    return {"threads_per_row": out[0], "vecs_per_thread": out[1]}


def floor_launch(blocks: int, threads: int, device: torch.device) -> None:
    """Launch an empty kernel of ``blocks`` x ``threads`` on ``device``'s
    current stream (not counted in ``launches``)."""
    err = _lib().rmsnorm_floor_launch(blocks, threads,
                                      torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of each row of ``x`` (M, D), fp32 or bf16, with fp32 ``w``
    (D,), or (G, D) taken by the rows in turn."""
    on_cpu = x.device.type == "cpu" and w.device.type == "cpu"
    if not on_cpu and torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("rmsnorm: the CUDA kernel has no backward; call it under "
                           "torch.no_grad() or on inputs that do not require grad")
    if on_cpu:
        return rmsnorm_plain(x, w, eps)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    check_inputs(x, w)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    global launches
    err = _lib().rmsnorm_grouped_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
        w.shape[0] if w.dim() == 2 else 1, eps, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err}")
    launches += 1
    return out
