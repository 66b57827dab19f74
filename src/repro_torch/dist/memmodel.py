"""Analytic per-device memory model (the port of ``repro.dist.memmodel``).

Sharded params (+ grads + AdamW moments for training), the layer-boundary
activation working set, and the decode state, in closed form.  Every
term derives from the same ``abstract_params`` / ``abstract_decode_state``
trees and ``sharding.py`` placements as the reference's, with the same
integers: params counted in bf16 but the fp32 leaves (the reference
model's serving dtype; its trainer keeps fp32 params), bf16 activations.
"""

from __future__ import annotations

import math

from ..models.config import ModelConfig
from ..models.model import abstract_decode_state, abstract_params
from ..train.optimizer import leaves
from .sharding import decode_state_shardings, mesh_shape, param_shardings

__all__ = ["param_bytes_per_device", "analytic_memory", "H100_HBM_BYTES"]

# torch.cuda.get_device_properties(0).total_memory on an
# NVIDIA H100 80GB HBM3 (the card of the port's runs)
H100_HBM_BYTES = 85_017_493_504


def _shard_bytes(tree: dict, shardings: dict, itemsize: int | None = None) -> int:
    """Per-device bytes of a tree of (meta) tensors under its shardings."""
    total = 0
    for t, sh in zip(leaves(tree), leaves(shardings)):
        local = sh.shard_shape(tuple(t.shape))
        total += math.prod(local) * (itemsize or t.element_size())
    return total


def param_bytes_per_device(cfg: ModelConfig, mesh) -> int:
    """Model-weight bytes each device holds (mostly bf16, a few fp32
    specials — norms, SSM decay terms)."""
    return _shard_bytes(abstract_params(cfg), param_shardings(cfg, mesh))


def analytic_memory(cfg: ModelConfig, mesh, kind: str, batch: int, seq: int,
                    microbatches: int = 1) -> dict:
    """Per-device memory breakdown for one (kind, batch, seq) cell."""
    params_abs = abstract_params(cfg)
    params_sh = param_shardings(cfg, mesh)
    shape = mesh_shape(mesh)
    dp_total = shape.get("data", 1) * shape.get("pod", 1)
    out = {"params": _shard_bytes(params_abs, params_sh)}
    if kind == "train":
        # grads mirror param placement/dtype; AdamW m+v are fp32
        out["grads"] = out["params"]
        out["opt"] = 2 * _shard_bytes(params_abs, params_sh, itemsize=4)
        local_tokens = (batch // max(microbatches, 1)) * seq // max(dp_total, 1)
        # remat keeps one bf16 residual per layer boundary for the backward
        out["acts"] = local_tokens * cfg.d_model * 2 * (cfg.n_layers + 1)
    elif kind == "prefill":
        local_tokens = batch * seq // max(dp_total, 1)
        # forward-only working set: a handful of live layer boundaries
        out["acts"] = local_tokens * cfg.d_model * 2 * 4
    else:  # decode
        out["kv"] = _shard_bytes(
            abstract_decode_state(cfg, batch, seq),
            decode_state_shardings(cfg, mesh, batch, seq),
        )
        out["acts"] = (batch // max(dp_total, 1)) * cfg.d_model * 2 * 4
    out["total"] = sum(out.values())
    out["fits_h100_80gb"] = out["total"] <= H100_HBM_BYTES
    return out
