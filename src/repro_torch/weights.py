"""The weight bridge: a parameter tree as NumPy arrays to the port's tensors.

The JAX package's ``init_params`` tree, taken to the host with
``jax.tree.map(np.asarray, params)`` by the caller, maps leaf for leaf
onto the port's tree (same keys, same stacked leading-L axes), so both
packages run the same weights.  bfloat16 leaves (``ml_dtypes.bfloat16``
arrays) cross as their uint16 bit patterns, the scheme of
``repro.train.checkpoint``'s bf16 store: bit for bit, no widening.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .models.model import keeps_fp32


def tensor_from_numpy(arr: np.ndarray, device="cuda") -> torch.Tensor:
    """One leaf; bf16 via its uint16 bits.  The array is copied first
    (``np.asarray`` of a JAX array is read-only)."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))


def params_from_numpy(tree: dict, device="cuda", dtype=None) -> dict:
    """The port's parameter dict from a tree of NumPy arrays.

    ``dtype=None`` keeps every leaf's dtype; a torch dtype casts every
    floating leaf except those the models keep in fp32 (``keeps_fp32``:
    the norm weights and the SSM's A_log, dt_bias, D_skip), as
    ``init_params`` would have made them."""
    dev = resolve_device(device)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            t = tensor_from_numpy(v, dev)
            if dtype is not None and t.is_floating_point() and not keeps_fp32(k):
                t = t.to(dtype)
            out[k] = t
        return out

    return walk(tree)
