"""Natural-shape wrappers over the kernels, dispatching by device.

The port's ``repro.kernels.ops``: callers pass (..., D) activations,
(B, S, H, D) attention inputs, the SSD scan's (B, S, H, P) inputs and
the triad's flat vectors.
A CUDA tensor goes to the hand-written kernel (or the wrapper raises); a
CPU tensor to its plain version.
Unlike the JAX wrapper nothing is padded or repeated here: the attention
kernel masks the ragged tail and reads shared kv heads itself, and the
SSD kernel pre-scales x by dt and takes the cumulative sum itself, and
the triad kernel does its ragged tail itself (the JAX wrapper pads to
262144-element tiles).

The kernels have no backward.  Training takes the plain versions on
every device, and says so explicitly: inside ``plain_kernels()`` the
attention, rmsnorm and SSD ops call the plain versions (which autograd
differentiates) and launch nothing; outside it they dispatch by device
as above, and a CUDA input that requires grad makes the kernel's wrapper
raise.  The switch is a context variable: it holds for the calling
thread (and the tasks it starts), not for other threads, so a serve
engine elsewhere in the process keeps its kernels.

A ``FakeTensor`` input (``torch._subclasses.fake_tensor``: shapes and
dtypes, no data), and only such an input, takes a stand-in outside
``plain_kernels()``: it refuses what the kernel refuses for the inputs'
shapes, dtypes and strides, allocates exactly the kernel's outputs (fake
too) and adds the kernel's ``cost`` to the innermost ``kernel_tally()``.  The dry run
(``launch/dryrun.py``) traces the serve paths so, as the card runs them,
without the plain versions' buffers (plain attention at a 32k prompt
would hold S^2 fp32 scores a head).  A real tensor never reaches a
stand-in.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import flash_attention as _fa
from . import rmsnorm as _rn
from . import ssd_scan as _ss
from .flash_attention import attention_plain, flash_attention
from .rmsnorm import rmsnorm, rmsnorm_plain
from .ssd_scan import ssd_plain, ssd_scan
from .stream_triad import stream_triad

__all__ = ["attention", "kernel_route", "kernel_tally", "plain_kernels", "plain_route",
           "rmsnorm_op", "ssd", "triad"]

_PLAIN = contextvars.ContextVar("repro_torch_plain_kernels", default=False)
_TALLY = contextvars.ContextVar("repro_torch_kernel_tally", default=None)


@contextlib.contextmanager
def plain_kernels(on: bool = True):
    """Within the block, ``attention``, ``rmsnorm_op`` and ``ssd`` run the
    kernels' plain versions on every device (``on=False``: dispatch by
    device again)."""
    token = _PLAIN.set(on)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def plain_route() -> bool:
    """Whether the calling context is inside ``plain_kernels()``."""
    return _PLAIN.get()


def kernel_route(t: torch.Tensor) -> bool:
    """Whether ``t``, outside ``plain_kernels()``, takes a kernel: a CUDA
    tensor (the kernel) or a fake one (its stand-in)."""
    return t.device.type == "cuda" or isinstance(t, FakeTensor)


@contextlib.contextmanager
def kernel_tally():
    """Within the block, each stand-in call adds its kernel's ``cost``
    under the kernel's name: ``{name: {"calls", "flops", "operations",
    "bytes", "transcendentals"}}``, the dict yielded."""
    tally: dict = {}
    token = _TALLY.set(tally)
    try:
        yield tally
    finally:
        _TALLY.reset(token)


def _stand_in(name: str, cost: dict) -> None:
    tally = _TALLY.get()
    if tally is not None:
        row = tally.setdefault(name, dict.fromkeys(("calls", *cost), 0))
        row["calls"] += 1
        for k, v in cost.items():
            row[k] += v


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, softcap: float | None = None,
              scale: float | None = None) -> torch.Tensor:
    """GQA flash attention: q (B, S, H, D), k/v (B, S, KH, D) -> (B, S, H, D),
    the logits scaled by ``scale`` (1 / sqrt(D) if None) and capped at
    ``softcap`` if it is given."""
    if _PLAIN.get():
        return attention_plain(q, k, v, causal, softcap, scale)
    if isinstance(q, FakeTensor):
        _fa.check_inputs(q, k, v)
        _stand_in("flash_attention", _fa.cost(*q.shape[:3], k.shape[2], q.shape[3],
                                              causal=causal, softcap=softcap, dtype=q.dtype))
        return torch.empty_like(q)
    return flash_attention(q, k, v, causal=causal, softcap=softcap, scale=scale)


def rmsnorm_op(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of any (..., D) tensor (a strided one is
    copied to dense rows first), with ``w`` (D,), or (G, D) for a
    (..., G, D) tensor normed by groups (each group its own weight row):
    one kernel launch either way."""
    if _PLAIN.get():
        return rmsnorm_plain(x, w, eps)
    shape = x.shape
    rows = x.reshape(-1, shape[-1]).contiguous()  # the kernel reads dense rows
    if isinstance(x, FakeTensor):
        _rn.check_inputs(rows, w)
        _stand_in("rmsnorm", _rn.cost(*rows.shape, x.dtype,
                                      groups=w.shape[0] if w.dim() == 2 else 1))
        return torch.empty_like(rows).reshape(shape)
    return rmsnorm(rows, w, eps).reshape(shape)


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, bm: torch.Tensor,
        cm: torch.Tensor, *, chunk: int = 64, return_state: bool = False):
    """Mamba2 SSD with natural layouts (drop-in for ``ssd_chunked``): x
    (B, S, H, P), dt (B, S, H), a_log (H,), bm/cm (B, S, N) or (B, S, G,
    N) in groups -> y (B, S, H, P), and with ``return_state`` also the
    (B, H, P, N) fp32 state."""
    if _PLAIN.get():
        return ssd_plain(x, dt, a_log, bm, cm, chunk, return_state=return_state)
    if isinstance(x, FakeTensor):
        _ss.check_inputs(x, dt, a_log, bm, cm, chunk)
        b, s, h, p = x.shape
        n = bm.shape[-1]
        _stand_in("ssd_scan", _ss.cost(b, s, h, p, n, chunk, x.dtype,
                                       groups=bm.shape[2] if bm.dim() == 4 else 1))
        y = x.new_empty((b, s, h, p))
        state = x.new_empty((b, h, p, n), dtype=torch.float32)
        return (y, state) if return_state else y
    y, state = ssd_scan(x, dt, a_log, bm, cm, chunk)
    return (y, state) if return_state else y


def triad(b: torch.Tensor, c: torch.Tensor, s: float = 3.0) -> torch.Tensor:
    """STREAM triad ``b + s * c`` over flat vectors of any length."""
    return stream_triad(b, c, s)
