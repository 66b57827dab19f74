"""The train step in PyTorch (the port of ``repro.train.train_step``).

``make_train_step`` closes over (config, optimizer config) and returns a
function ``(params, opt_state, batch) -> (params, opt_state, metrics)``.
The loss and its gradients come from ``models.loss_fn`` (the kernels'
plain versions, differentiated by autograd); the parameters and moments
are updated in place (``optimizer.adamw_update``).

* gradient accumulation over microbatches, taken in order, each
  microbatch's gradients added into one accumulator in place;
* optional gradient compression, as the reference applies it before
  the cross-data-axis reduction: bf16 (the accumulator itself is bf16),
  or int8 with error feedback (the residual is carried in opt_state).

Data parallelism (``group``, the data axis's process group): each rank
computes the loss and gradients of its own rows of the global batch,
and the gradients are averaged over the group by ``all_reduce`` before
the optimizer — the reduction the reference leaves to GSPMD.  With bf16
compression they are reduced in bf16 (the reference casts before its
cross-data reduction); int8 with error feedback compresses the reduced
fp32 gradients, the reference's order.  The reduction runs whatever the
group's size, so a group of one still makes its collective calls.  The
loss is reported as the global mean.  Params and moments stay replicated
(``dist.sharding.param_shardings`` gives every leaf ``()`` at model = 1),
and every rank applies the same update to them.

The reference's other mesh options are not ported: ``grad_shardings``
and its ``_pin`` (reduce-scattering gradients into model-axis shards,
which waits for training with model > 1), the microbatch ``constrain``,
and ``TrainStepConfig.sp``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..models import loss_fn
from ..models.config import ModelConfig
from .optimizer import AdamWConfig, adamw_init, adamw_update, leaves, tree_map


@dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: bool = True
    grad_compression: str = "none"  # none | bf16 | int8_ef


def _compress_decompress(g, residual=None, *, how: str):
    """Lossy-compress a gradient leaf; returns (g', new_residual)."""
    if how == "bf16":
        return g.to(torch.bfloat16).to(torch.float32), None
    if how == "int8_ef":
        gf = g.to(torch.float32)
        if residual is not None:
            gf = gf + residual
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        return deq, gf - deq  # error feedback residual
    return g, residual


def _reduce_mean(tensors: list, group) -> None:
    """Average ``tensors`` in place over the ranks of ``group`` (a sum by
    ``all_reduce``, then the scale, which a group of one skips: x · 1 is x)."""
    world = dist.get_world_size(group)
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        if world > 1:
            t.mul_(1.0 / world)


def _unflatten_like(tree: dict, flat: list) -> dict:
    """``tree``'s keys over the tensors of ``flat`` (in ``leaves`` order)."""
    it = iter(flat)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}

    return build(tree)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    ts: TrainStepConfig = TrainStepConfig(), group=None):
    """Build the train step.  ``params`` is updated in place and returned;
    ``metrics`` holds 0-d tensors on the params' device (``loss``,
    ``grad_norm``, ``lr``), read by the caller when it needs them.  With
    ``group`` (a process group over the data axis) the batch is this
    rank's rows and the gradients and loss are averaged over the group."""

    def grads_of(params, batch):
        # views of the parameters that require grad: the caller's tensors
        # stay as they are (a serve path on them keeps its kernels)
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        loss = loss_fn(cfg, _unflatten_like(params, flat), batch, remat=ts.remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        return loss.detach(), list(grads)

    def mb_slice(x, i):
        b = x.shape[0]
        # mrope positions carry a leading (3,) stream dim: slice their
        # batch axis (dim 1) instead
        axis = 1 if (x.dim() >= 2 and b == 3 and cfg.pos_embedding == "mrope") else 0
        per = x.shape[axis] // ts.microbatches
        return x.narrow(axis, i * per, per)

    def train_step(params, opt_state, batch):
        if ts.microbatches > 1:
            # bf16 compression accumulates in bf16, as the reference casts
            # before its cross-data grad reduction
            acc_t = torch.bfloat16 if ts.grad_compression == "bf16" else torch.float32
            loss = None
            grads = None
            for i in range(ts.microbatches):
                li, gi = grads_of(params, {k: mb_slice(v, i) for k, v in batch.items()})
                loss = li if loss is None else loss + li
                gi = [g.to(acc_t) for g in gi]
                if grads is None:
                    grads = gi
                else:
                    for acc, g in zip(grads, gi):
                        acc.add_(g)
                del gi
            inv = 1.0 / ts.microbatches
            loss = loss * inv
            for g in grads:
                g.mul_(inv)
        else:
            loss, grads = grads_of(params, batch)

        if group is not None:
            if ts.grad_compression == "bf16":  # cast before the reduction
                grads = [g.to(torch.bfloat16) for g in grads]
            _reduce_mean(grads + [loss], group)

        residuals = None
        if ts.grad_compression != "none":
            if ts.grad_compression == "int8_ef":
                res = opt_state.get("ef_residual")
                residuals = (leaves(res) if res is not None
                             else [torch.zeros_like(g, dtype=torch.float32) for g in grads])
                pairs = [_compress_decompress(g, r, how="int8_ef")
                         for g, r in zip(grads, residuals)]
                residuals = [r for _, r in pairs]
            else:
                pairs = [_compress_decompress(g, how=ts.grad_compression) for g in grads]
            grads = [g for g, _ in pairs]
            del pairs

        core_state = {k: v for k, v in opt_state.items() if k != "ef_residual"}
        params, core_state, aux = adamw_update(opt, params, _unflatten_like(params, grads),
                                               core_state)
        if residuals is not None:
            core_state["ef_residual"] = _unflatten_like(params, residuals)
        return params, core_state, {"loss": loss, **aux}

    return train_step


def init_opt_state(cfg: ModelConfig, params: dict,
                   ts: TrainStepConfig = TrainStepConfig()) -> dict:
    state = adamw_init(params)
    if ts.grad_compression == "int8_ef":
        state["ef_residual"] = tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return state
