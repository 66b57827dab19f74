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

On a (data, model) ``mesh`` (``launch.mesh.make_local_mesh``) the step
is the SPMD program GSPMD makes of the reference's jitted step, written
by hand:

* data axis: the step takes the global batch, as the reference's jitted
  step does, cuts each microbatch from it in the reference's order
  (rows ``[i·B/mb, (i+1)·B/mb)``) and gives each rank its own rows of
  that microbatch (``data.shard_batch``: every rank of a ``model`` group
  the same rows; the whole microbatch where the data axes do not divide
  it, ``batch_shardings``' rule).  The forward is told which
  (``mesh_context(mesh, rows_split=)``: the MoE capacity is the whole
  microbatch's).  Each rank computes the loss and gradients of its rows,
  and the gradients are averaged over the data group by ``all_reduce``
  before the optimizer.  With bf16 compression they are reduced in bf16
  (the reference casts before its cross-data reduction); int8 with
  error feedback compresses the reduced fp32 gradients, the reference's
  order.  The reduction runs whatever the group's size, so a group of
  one still makes its collective calls.  The loss is reported as the
  global mean.
* model axis: params and moments are this rank's blocks, as
  ``dist.sharding.param_shardings`` places them (none at model = 1).
  The forward runs under ``dist.mesh_context(mesh)``, which gathers each
  leaf where the model uses it; the gather's backward keeps this rank's
  block of the gradient, so each gradient arrives on its parameter's
  placement, what the reference's ``_pin`` asks of GSPMD.  No reduction
  over ``model`` is needed: its ranks computed the same gradient.  The
  global norm sums the blocks over the model group; int8 compression
  takes its scale from the whole leaf's max.

The reference's microbatch ``constrain`` and ``TrainStepConfig.sp`` are
not ported.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..dist.hints import mesh_context
from ..dist.sharding import batch_shardings, param_shardings
from ..models import loss_fn
from ..models.config import ModelConfig
from .data import shard_batch
from .optimizer import AdamWConfig, adamw_init, adamw_update, leaves, tree_map


@dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: bool = True
    grad_compression: str = "none"  # none | bf16 | int8_ef


def _compress_decompress(g, residual=None, *, how: str, group=None):
    """Lossy-compress a gradient leaf; returns (g', new_residual).  With
    ``group`` (a block of a leaf sharded over it) int8's scale is the
    whole leaf's: the max over the group."""
    if how == "bf16":
        return g.to(torch.bfloat16).to(torch.float32), None
    if how == "int8_ef":
        gf = g.to(torch.float32)
        if residual is not None:
            gf = gf + residual
        amax = gf.abs().max()
        if group is not None:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        return deq, gf - deq  # error feedback residual
    return g, residual


def _reduce_mean(tensors: list, group) -> None:
    """Average ``tensors`` in place over the ranks of ``group`` (a sum by
    ``all_reduce``, then the scale, which a group of one skips: x · 1 is x)."""
    world = dist.get_world_size(group)
    for t in tensors:
        if not t.is_contiguous():  # a collective reads the storage as one dense run
            raise ValueError(f"a gradient of shape {tuple(t.shape)} is not contiguous")
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        if world > 1:
            t.mul_(1.0 / world)


def _unflatten_like(tree: dict, flat: list) -> dict:
    """``tree``'s keys over the tensors of ``flat`` (in ``leaves`` order)."""
    return _build(tree, iter(flat))


def _build(node: dict, it) -> dict:
    # a module-level function: a recursive closure over ``it`` would be a
    # reference cycle holding the step's tensors (views of the params)
    # until the garbage collector ran, after the caller had let them go
    return {k: _build(node[k], it) if isinstance(node[k], dict) else next(it)
            for k in sorted(node)}


def model_sharded(cfg: ModelConfig, mesh) -> list[bool]:
    """Which param leaves (in ``leaves`` order) the mesh's ``model`` axis
    shards."""
    from ..dist.shard import model_dim

    return [model_dim(s) is not None for s in leaves(param_shardings(cfg, mesh))]


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    ts: TrainStepConfig = TrainStepConfig(), mesh=None):
    """Build the train step.  ``params`` is updated in place and returned;
    ``metrics`` holds 0-d tensors on the params' device (``loss``,
    ``grad_norm``, ``lr``), read by the caller when it needs them.  With
    ``mesh`` (a (data, model) ``DeviceMesh``) the batch is still the
    global one, of which each microbatch's rows are split over the data
    axes; params and moments are this rank's blocks, and the gradients
    and loss are averaged over the data group."""
    group = mesh.get_group("data") if mesh is not None else None
    sharded, mgroup = None, None
    if mesh is not None and any(flags := model_sharded(cfg, mesh)):
        sharded, mgroup = flags, mesh.get_group("model")

    def grads_of(params, batch):
        # views of the parameters that require grad: the caller's tensors
        # stay as they are (a serve path on them keeps its kernels)
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        on_mesh = contextlib.nullcontext()
        if mesh is not None:  # this rank's rows of the (micro)batch
            rows = batch["labels"].shape[0]
            split = any(e is not None for e in
                        batch_shardings(cfg, mesh, "train", rows)["labels"].spec)
            batch = shard_batch(cfg, batch, mesh)
            on_mesh = mesh_context(mesh, rows_split=split)
        # the backward runs outside the mesh context: the remat recompute
        # enters it again itself (models.model._remat)
        with on_mesh:
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
                pairs = [_compress_decompress(g, r, how="int8_ef",
                                              group=mgroup if sharded and sharded[i] else None)
                         for i, (g, r) in enumerate(zip(grads, residuals))]
                residuals = [r for _, r in pairs]
            else:
                pairs = [_compress_decompress(g, how=ts.grad_compression) for g in grads]
            grads = [g for g, _ in pairs]
            del pairs

        core_state = {k: v for k, v in opt_state.items() if k != "ef_residual"}
        params, core_state, aux = adamw_update(opt, params, _unflatten_like(params, grads),
                                               core_state, sharded, mgroup)
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
