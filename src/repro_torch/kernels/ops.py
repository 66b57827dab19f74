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
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from .flash_attention import attention_plain, flash_attention
from .rmsnorm import rmsnorm, rmsnorm_plain
from .ssd_scan import ssd_plain, ssd_scan
from .stream_triad import stream_triad

__all__ = ["attention", "plain_kernels", "plain_route", "rmsnorm_op", "ssd", "triad"]

_PLAIN = contextvars.ContextVar("repro_torch_plain_kernels", default=False)


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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, softcap: float | None = None) -> torch.Tensor:
    """GQA flash attention: q (B, S, H, D), k/v (B, S, KH, D) -> (B, S, H, D),
    the logits capped at ``softcap`` if it is given."""
    if _PLAIN.get():
        return attention_plain(q, k, v, causal, softcap)
    return flash_attention(q, k, v, causal=causal, softcap=softcap)


def rmsnorm_op(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of any (..., D) tensor."""
    if _PLAIN.get():
        return rmsnorm_plain(x, w, eps)
    shape = x.shape
    return rmsnorm(x.reshape(-1, shape[-1]), w, eps).reshape(shape)


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, bm: torch.Tensor,
        cm: torch.Tensor, *, chunk: int = 64, return_state: bool = False):
    """Mamba2 SSD with natural layouts (drop-in for ``ssd_chunked``): x
    (B, S, H, P), dt (B, S, H), a_log (H,), bm/cm (B, S, N) -> y (B, S,
    H, P), and with ``return_state`` also the (B, H, P, N) fp32 state."""
    if _PLAIN.get():
        return ssd_plain(x, dt, a_log, bm, cm, chunk, return_state=return_state)
    y, state = ssd_scan(x, dt, a_log, bm, cm, chunk)
    return (y, state) if return_state else y


def triad(b: torch.Tensor, c: torch.Tensor, s: float = 3.0) -> torch.Tensor:
    """STREAM triad ``b + s * c`` over flat vectors of any length."""
    return stream_triad(b, c, s)
