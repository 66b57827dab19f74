"""Parameters on the ``model`` mesh axis: each rank's blocks, gathered
where the model uses them.

The reference places each parameter with ``sharding.param_shardings``
(the trailing-most dimension the ``model`` axis divides, never a
layer-stack dimension) and leaves the rest to GSPMD, which gathers a
leaf where a product needs it whole.  The port's model body runs on
each rank's local tensors, so it does that gathering by hand:

* ``block_of`` / ``shard_leaf`` / ``shard_tree`` — this rank's block of
  a tensor under a spec: per sharded dimension the block ``Dmap`` of the
  spec's grid, read through the PITFALLS index algebra
  (``Dmap.global_block_range``), as ``spec_via_dmap`` checks it.
* ``gather_leaf`` — the whole leaf from the blocks of the ``model``
  group (``all_gather_into``), differentiable.  Its backward
  returns this rank's block of the incoming gradient and reduces
  nothing over ``model``: ``batch_shardings`` replicates the batch over
  ``model``, so every rank of a ``model`` group computes the same
  gradient of the whole leaf, and a sum over the group would add M equal
  copies.  The reduction over the data axes stays the train step's
  ``all_reduce`` mean, on the blocks.
* ``gather_params`` — the model body's hook (``models.model._gathered``):
  one layer's leaves, the hybrid's shared block, or the top-level
  leaves (embedding, final norm, head), each leaf the active mesh shards
  gathered whole; a leaf it replicates is passed through untouched and
  no collective is called for it.

A mesh here is a ``DeviceMesh`` (or any object with its
``mesh_dim_names``, ``shape``, ``get_local_rank`` and, for the gathers,
``get_group``).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..core.dmap import Dmap

__all__ = ["all_gather_into", "block_of", "gather_full", "gather_leaf",
           "gather_params", "model_dim", "shard_leaf", "shard_tree", "take_block"]

# the group's equal-sized blocks joined along dim 0 into one output:
# ``all_gather_single`` where torch has it (it deprecates the older name)
all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

# whole leaves gathered over a model group (forward and recompute), for
# tests that hold the recompute to its gathers
gathers = 0


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _spec(spec) -> tuple:
    """A spec tuple, from a ``sharding.Sharding`` or a spec itself."""
    return tuple(getattr(spec, "spec", spec))


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _axis_coord(mesh, entry) -> tuple[int, int]:
    """This rank's (coordinate, parts) along the mesh axes a spec entry
    names (a name or a tuple of names, major first: mixed radix)."""
    sizes = _sizes(mesh)
    coord, parts = 0, 1
    for name in _names(entry):
        if name in sizes:
            coord = coord * sizes[name] + mesh.get_local_rank(name)
            parts *= sizes[name]
    return coord, parts


def block_of(shape, spec, mesh) -> list[list[int]]:
    """This rank's half-open ``[start, stop)`` range of each dimension of
    a tensor of ``shape`` placed by ``spec`` on ``mesh``."""
    out = [[0, int(n)] for n in shape]
    for d, entry in enumerate(_spec(spec)):
        coord, parts = _axis_coord(mesh, entry)
        if parts > 1:
            lo, hi = Dmap([parts]).global_block_range((int(shape[d]),), 0, coord)
            out[d] = [int(lo), int(hi)]
    return out


def take_block(t: torch.Tensor, block) -> torch.Tensor:
    """``t``'s ``block`` as a contiguous copy that does not keep ``t``'s
    storage alive; ``t`` itself when the block is all of it (or None)."""
    if block is None or all(lo == 0 and hi == n for (lo, hi), n in zip(block, t.shape)):
        return t
    for d, (lo, hi) in enumerate(block):
        t = t.narrow(d, lo, hi - lo)
    return t.clone(memory_format=torch.contiguous_format)


def shard_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``."""
    return take_block(t, block_of(t.shape, spec, mesh))


def shard_tree(tree: dict, shardings: dict, mesh) -> dict:
    """This rank's block of each leaf of ``tree`` (``shardings`` a tree
    of specs or ``Sharding``\\ s with the same keys)."""
    return {k: shard_tree(v, shardings[k], mesh) if isinstance(v, dict)
            else shard_leaf(v, shardings[k], mesh) for k, v in tree.items()}


def model_dim(spec) -> int | None:
    """The dimension ``spec`` puts on the ``model`` axis, or None."""
    dims = [d for d, e in enumerate(_spec(spec)) if "model" in _names(e)]
    if not dims:
        return None
    if len(dims) > 1 or len(_names(_spec(spec)[dims[0]])) > 1:
        raise NotImplementedError(f"spec {_spec(spec)}: a leaf is gathered over "
                                  "the model axis alone, on one dimension")
    return dims[0]


def _all_gather(shard: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The blocks of ``group`` joined along ``dim``, in the meshless
    leaf's (contiguous) layout."""
    global gathers
    gathers += 1
    x = shard.movedim(dim, 0).contiguous()
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    all_gather_into(out, x, group=group)
    return out.movedim(0, dim).contiguous()


class _GatherModel(torch.autograd.Function):
    """Forward: the whole leaf from the model group's blocks.  Backward:
    this rank's block of the gradient, with no reduction over the group."""

    @staticmethod
    def forward(ctx, shard, dim, group, size, rank):
        ctx.dim, ctx.rank, ctx.block = dim, rank, shard.shape[dim]
        return _all_gather(shard, dim, group, size)

    @staticmethod
    def backward(ctx, grad):
        # contiguous: the data axis's all_reduce reads the gradient's
        # storage as one dense run
        block = grad.narrow(ctx.dim, ctx.rank * ctx.block, ctx.block).contiguous()
        return block, None, None, None, None


def _model_axis(mesh) -> tuple:
    """(group, size, this rank's index) of the mesh's ``model`` axis."""
    return mesh.get_group("model"), _sizes(mesh)["model"], mesh.get_local_rank("model")


def gather_leaf(shard: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block (``spec`` in the block's own
    dimensions): an all-gather over the ``model`` group, whose backward
    keeps this rank's block of the gradient.  ``shard`` itself where the
    spec puts nothing on a ``model`` axis of more than one rank."""
    dim = model_dim(spec)
    if dim is None or _sizes(mesh).get("model", 1) == 1:
        return shard
    return _GatherModel.apply(shard, dim, *_model_axis(mesh))


def gather_full(shard: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``gather_leaf`` outside autograd (checkpoints)."""
    with torch.no_grad():
        return gather_leaf(shard, spec, mesh)


@functools.lru_cache(maxsize=32)
def _plan(cfg, sizes: tuple) -> dict:
    """For each part the model body gathers ("top": the embedding, final
    norm and head; "layer": one layer's leaves, the layer-stack dims
    dropped; "shared": the hybrid's shared block), the dimension of each
    leaf the ``model`` axis of a mesh of ``sizes`` ((name, size) pairs)
    shards, by key; empty where it shards none."""
    from .sharding import param_shardings

    sizes = dict(sizes)
    if sizes.get("model", 1) == 1:
        return {"top": {}, "layer": {}, "shared": {}}
    sh = param_shardings(cfg, sizes)
    stack = 2 if cfg.family == "hybrid" else 1

    def dims(tree, drop):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                sub = dims(v, drop)
                if sub:
                    out[k] = sub
            elif (d := model_dim(v)) is not None:
                out[k] = d - drop
        return out

    return {"top": dims({k: v for k, v in sh.items() if k not in ("layers", "shared")}, 0),
            "layer": dims(sh["layers"], stack), "shared": dims(sh.get("shared", {}), 0)}


def gather_params(cfg, mesh, p: dict, part: str) -> dict:
    """``p`` (the params of ``part``: "top", "layer" or "shared") with each
    leaf the ``model`` axis of ``mesh`` shards gathered whole; ``p``
    itself where it shards none."""
    plan = _plan(cfg, tuple(_sizes(mesh).items()))[part]
    if not plan:
        return p
    return _gather_walk(p, plan, _model_axis(mesh))


def _gather_walk(node: dict, sub: dict, axis: tuple) -> dict:
    """``node`` with the leaves ``sub`` names gathered over ``axis``
    ((group, size, rank)); a module-level function, so that no closure
    cycle keeps the leaves past the caller."""
    out = dict(node)
    for k, d in sub.items():
        out[k] = (_gather_walk(node[k], d, axis) if isinstance(d, dict)
                  else _GatherModel.apply(node[k], d, *axis))
    return out
