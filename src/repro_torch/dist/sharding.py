"""Dmap → ``torch.distributed`` placements: spec trees for the model
stack (the port of ``repro.dist.sharding``).

The paper's ``Dmap`` answers "which rank owns which block"; a per-dim
spec (JAX's ``PartitionSpec``: the mesh axis name, a tuple of names, or
None for each tensor dim) answers the same question for a named mesh,
and ``placements`` turns it into the per-mesh-dim ``Shard(d)`` /
``Replicate()`` list a ``DTensor`` takes.  ``spec_via_dmap`` is the
bridge: it builds the equivalent block ``Dmap`` for a requested
partitioning and checks — through the PITFALLS index algebra, not a
parallel reimplementation — that every device gets the even block a
``Shard`` gives, degrading any non-divisible dimension to replicated
rather than erroring (the maps-off philosophy).

The ``*_shardings`` functions give trees of ``Sharding`` (a spec and its
placements) for params, optimizer state, batches, logits, decode state
and the serve engine's carry.  They read nothing but the mesh's axis
names and sizes — a ``DeviceMesh``, or a mapping ``{name: size}`` in
mesh order — so a tree can be built for a mesh shape with no devices
behind it.  Placement rules, as in the reference:

* params — the trailing-most dimension divisible by the ``model`` axis is
  tensor-sharded; leading layer-stack dimensions are never sharded;
  everything else replicates.
* batch-like tensors — the batch dimension shards over the data axes
  (``("pod", "data")`` on multi-pod meshes), all model dims replicate.

Shapes come from ``models.model.param_shapes`` and
``abstract_decode_state`` (``init_decode_state`` on the ``meta``
device).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch

from ..core.dmap import Dmap
from ..models.config import ModelConfig
from ..models.model import abstract_decode_state, param_shapes

__all__ = [
    "Sharding",
    "mesh_shape",
    "dp_axes",
    "spec_via_dmap",
    "placements",
    "param_shardings",
    "opt_state_shardings",
    "batch_shardings",
    "logits_sharding",
    "decode_state_shardings",
    "serve_carry_shardings",
]


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or of a
    mapping already in that form."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs mesh_dim_names")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def _axis_names(a) -> tuple[str, ...]:
    if a is None:
        return ()
    if isinstance(a, (tuple, list)):
        return tuple(a)
    return (a,)


def placements(mesh, spec: Sequence[Any]) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: for each mesh
    dim, ``Shard(d)`` where tensor dim ``d`` names it, else
    ``Replicate()``.  A dim sharded over several axes (``("pod",
    "data")``) shards over each in mesh order, major first, as the
    reference's tuple entry does."""
    from torch.distributed.tensor import Replicate, Shard

    owner: dict[str, int] = {}
    for d, a in enumerate(spec):
        for name in _axis_names(a):
            if name in owner:
                raise ValueError(f"mesh axis {name!r} shards two dims of {tuple(spec)}")
            owner[name] = d
    out = tuple(Shard(owner[n]) if n in owner else Replicate() for n in mesh_shape(mesh))
    return out


@dataclass(frozen=True)
class Sharding:
    """A spec on a named mesh shape (the reference's ``NamedSharding``):
    ``axes`` the mesh's (name, size) pairs in order, ``spec`` one entry
    per leading tensor dim (trailing dims replicate)."""

    axes: tuple[tuple[str, int], ...]
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(dict(self.axes), self.spec)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """Each device's block of a tensor of ``shape``."""
        sizes = dict(self.axes)
        out = list(int(s) for s in shape)
        for d, a in enumerate(self.spec):
            for name in _axis_names(a):
                out[d] //= sizes[name]
        return tuple(out)


def _sharding(mesh, spec) -> Sharding:
    return Sharding(tuple(mesh_shape(mesh).items()), tuple(spec))


def dp_axes(mesh):
    """The data-parallel mesh axes: cross-pod DP rides the ``pod`` axis."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else "data"


def _dp_total(mesh) -> int:
    shape = mesh_shape(mesh)
    return shape.get("data", 1) * shape.get("pod", 1)


def spec_via_dmap(mesh, shape: Sequence[int], axes: Sequence[Any]) -> tuple:
    """The spec for ``shape`` with dim ``i`` sharded over mesh axis
    ``axes[i]`` (a name, a tuple of names, or None): a tuple with the
    entries of the reference's ``PartitionSpec``.

    Names the mesh does not define are treated as replicated; so is any
    dimension the axis size does not divide evenly.  The surviving grid is
    cross-checked against the paper-side index algebra: a block ``Dmap``
    of the same grid must give every rank the identical even block.
    """
    sizes = mesh_shape(mesh)
    shape = tuple(int(s) for s in shape)
    axes = list(axes) + [None] * (len(shape) - len(axes))
    entries: list = []
    grid: list[int] = []
    for dim, a in zip(shape, axes):
        names = tuple(n for n in _axis_names(a) if n in sizes)
        size = math.prod(sizes[n] for n in names) if names else 1
        if size > 1 and dim % size == 0:
            entries.append(names if len(names) > 1 else names[0])
            grid.append(size)
        else:
            entries.append(None)
            grid.append(1)
    if 1 <= len(grid) <= 4 and math.prod(grid) > 1:
        dmap = Dmap(grid)
        for d, g in enumerate(grid):
            lo, hi = dmap.global_block_range(shape, d, dmap.proclist[0])
            assert hi - lo == shape[d] // g, (
                f"PITFALLS block ({lo},{hi}) disagrees with the even "
                f"partition of dim {d} ({shape[d]}/{g})"
            )
    return tuple(entries)


# ---------------------------------------------------------------------------
# Parameter / optimizer placement
# ---------------------------------------------------------------------------


def _n_stack_dims(cfg: ModelConfig, path: str) -> int:
    """Leading layer-stack dims a leaf carries (never sharded).  Hybrid
    stacks (groups, every, ...)."""
    if "/layers/" not in path:
        return 0
    return 2 if cfg.family == "hybrid" else 1


def _param_spec(cfg: ModelConfig, mesh, path: str, shape) -> tuple:
    msize = mesh_shape(mesh).get("model", 1)
    offset = _n_stack_dims(cfg, path)
    if msize > 1:
        for d in range(len(shape) - 1, offset - 1, -1):
            if shape[d] % msize == 0 and shape[d] >= msize:
                axes: list = [None] * len(shape)
                axes[d] = "model"
                return spec_via_dmap(mesh, shape, axes)
    return ()


def _walk(tree: dict, fn, prefix: str = "") -> dict:
    return {
        k: (
            _walk(v, fn, f"{prefix}/{k}")
            if isinstance(v, dict)
            else fn(f"{prefix}/{k}", v)
        )
        for k, v in tree.items()
    }


def param_shardings(cfg: ModelConfig, mesh) -> dict:
    """``Sharding`` tree matching ``param_shapes(cfg)``."""
    return _walk(param_shapes(cfg),
                 lambda path, shape: _sharding(mesh, _param_spec(cfg, mesh, path, shape)))


def opt_state_shardings(cfg: ModelConfig, mesh) -> dict:
    """AdamW state: m/v mirror the param placement, step replicates."""
    p = param_shardings(cfg, mesh)
    return {"m": p, "v": p, "step": _sharding(mesh, ())}


# ---------------------------------------------------------------------------
# Batch / activation placement
# ---------------------------------------------------------------------------


def _dp_spec(mesh, batch: int, lead: int = 0) -> tuple:
    """Shard ``batch`` (at position ``lead``) over the data axes; trailing
    dims replicate (a spec shorter than the rank is legal)."""
    if batch % _dp_total(mesh):
        return ()
    return (*([None] * lead), dp_axes(mesh))


def batch_shardings(cfg: ModelConfig, mesh, kind: str, batch: int) -> dict:
    """Input shardings keyed like the batch dict (``tokens`` or
    ``inputs_embeds``, ``labels``, M-RoPE's ``positions`` on dim 1;
    decode: ``tokens`` and ``pos``)."""
    sh: dict = {}
    if kind in ("train", "prefill"):
        key = "inputs_embeds" if cfg.frontend else "tokens"
        sh[key] = _sharding(mesh, _dp_spec(mesh, batch))
        if kind == "train":
            sh["labels"] = _sharding(mesh, _dp_spec(mesh, batch))
        if cfg.pos_embedding == "mrope":
            sh["positions"] = _sharding(mesh, _dp_spec(mesh, batch, lead=1))
    else:  # decode
        sh["tokens"] = _sharding(mesh, _dp_spec(mesh, batch))
        sh["pos"] = _sharding(mesh, ())
    return sh


def logits_sharding(cfg: ModelConfig, mesh, batch: int) -> Sharding:
    return _sharding(mesh, _dp_spec(mesh, batch))


def decode_state_shardings(cfg: ModelConfig, mesh, batch: int, max_seq: int) -> dict:
    """Decode-state tree: the batch dimension (the first dim of the
    family's state layout equal to ``batch``) shards over the data axes,
    the rest replicates."""

    def leaf(t: torch.Tensor) -> Sharding:
        if batch % _dp_total(mesh) == 0:
            for d, n in enumerate(t.shape):
                if n == batch:
                    return _sharding(mesh, _dp_spec(mesh, batch, lead=d))
        return _sharding(mesh, ())

    return {k: leaf(v) for k, v in abstract_decode_state(cfg, batch, max_seq).items()}


def serve_carry_shardings(cfg: ModelConfig, mesh, slots: int, max_seq: int) -> dict:
    """Placement tree for the continuous-batching engine's carry: the
    decode state shards its per-request batch axis over the data axes and
    every per-slot control vector its slot axis the same way."""
    vec = _sharding(mesh, _dp_spec(mesh, slots))
    return {
        "state": decode_state_shardings(cfg, mesh, slots, max_seq),
        "tokens": vec,
        "pos": vec,
        "active": vec,
        "gen": vec,
        "budget": vec,
        "temp": vec,
        "key": vec,
        "eos": vec,
    }
