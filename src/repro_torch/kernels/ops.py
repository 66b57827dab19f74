"""Natural-shape wrappers over the kernels, dispatching by device.

The port's ``repro.kernels.ops``: callers pass (..., D) activations and
(B, S, H, D) attention inputs.  A CUDA tensor goes to the hand-written
kernel (or the wrapper raises); a CPU tensor to its plain version.
Unlike the JAX wrapper nothing is padded or repeated here: the attention
kernel masks the ragged tail and reads shared kv heads itself.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .rmsnorm import rmsnorm

__all__ = ["attention", "rmsnorm_op"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """GQA flash attention: q (B, S, H, D), k/v (B, S, KH, D) -> (B, S, H, D)."""
    return flash_attention(q, k, v, causal=causal)


def rmsnorm_op(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of any (..., D) tensor."""
    shape = x.shape
    return rmsnorm(x.reshape(-1, shape[-1]), w, eps).reshape(shape)
