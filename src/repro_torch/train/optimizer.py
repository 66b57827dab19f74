"""AdamW + learning-rate schedules in PyTorch (the port of
``repro.train.optimizer``).

Schedules: cosine (default) and MiniCPM's **WSD** (warmup-stable-decay,
arXiv:2404.06395), selected per arch via ``ModelConfig.wsd_schedule``;
both are computed in fp32 tensors, as the reference computes them.

Optimizer state is ``{"m", "v", "step"}``: fp32 moments whatever the
param dtype and an int32 step, as in the reference.  Where the reference
returns new trees (and ``jax.jit`` donates the old buffers), the port
updates the parameters and moments *in place* under ``torch.no_grad()``:
at full width new trees would hold a second copy of p, m and v.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | wsd
    wsd_decay_frac: float = 0.1  # last 10% of steps decay (MiniCPM)


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(float(x), dtype=torch.float32)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Warmup + (cosine | WSD): a 0-d fp32 tensor on ``step``'s device
    (a Python number gives a CPU tensor)."""
    stepf = _f32(step)
    warm = torch.clamp((stepf + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1.0 - cfg.wsd_decay_frac)
        in_decay = torch.clamp(stepf - decay_start, min=0.0)
        span = max(cfg.total_steps * cfg.wsd_decay_frac, 1.0)
        # exponential tail to ~1e-2 of peak over the decay span
        # log(1e-2) rounded in fp32, as jnp.log rounds it; a Python float
        # holds it exactly, and no constant is copied to the device
        log_floor = float(torch.log(torch.tensor(1e-2, dtype=torch.float32)))
        decay = torch.exp(log_floor * in_decay / span)
        return cfg.lr * warm * decay
    # cosine to 10% of peak
    frac = torch.clamp(stepf / max(cfg.total_steps, 1), 0.0, 1.0)
    cos = 0.1 + 0.9 * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * cos


def leaves(tree: dict) -> list[torch.Tensor]:
    """The tree's tensors in sorted-key order, depth first: the order of
    ``jax.tree.leaves`` on the reference's dicts."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_map(fn, tree: dict) -> dict:
    """A new tree of ``fn(leaf)``, with the same keys."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def adamw_init(params: dict) -> dict:
    first = leaves(params)[0]
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def _global_norm(grads, sharded=None, group=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in fp32, the leaves
    summed one after another in sorted-key order as the reference sums
    them.  With ``group`` (the ``model`` axis's process group), the
    leaves ``sharded`` marks (one bool a leaf, in ``leaves`` order) are
    this rank's blocks: their sum is taken apart and summed over the
    group, and the replicated leaves are counted once.  The sum then runs
    in another order than the meshless one, so its bits may differ by an
    ulp."""
    total, part = 0, None
    for i, g in enumerate(leaves(grads)):
        sq = g.float().square().sum()
        if group is not None and sharded[i]:
            part = sq if part is None else part + sq
        else:
            total = total + sq
    if part is not None:
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
        total = total + part
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict,
                 sharded=None, group=None):
    """One AdamW step with global-norm clipping.  Returns (params, state,
    aux), aux carrying the grad norm (before clipping) and the LR applied.

    ``params`` and ``state["m"]``, ``state["v"]`` are updated in place and
    returned; the grads are scaled in place when they are fp32.  The
    returned state is a new dict over the same moment trees and a new
    step tensor.  On a ``model`` axis the leaves ``sharded`` marks are
    this rank's blocks, and ``group`` is the axis's group: the norm is
    the whole tree's (``_global_norm``); the update is elementwise, and
    a block keeps its leaf's rank, so the weight decay applies as to the
    whole leaf."""
    step = state["step"] + 1
    gnorm = _global_norm(grads, sharded, group)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bias1 = 1.0 - b1 ** stepf
    bias2 = 1.0 - b2 ** stepf

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g = g.float().mul_(scale)
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        delta = (m / bias1).div_((v / bias2).sqrt_().add_(cfg.eps))
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            delta.add_(p, alpha=cfg.weight_decay)
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float().sub_(delta))
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
