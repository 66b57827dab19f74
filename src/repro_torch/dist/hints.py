"""Sharding hints: ``constrain`` + ``mesh_context`` (the port of
``repro.dist.hints``).

``constrain(x, *axes)`` names the mesh axis each dimension of ``x`` is
sharded over (``None`` = replicated).  With no mesh installed through
``mesh_context``, or on a plain (local) tensor, it is the identity; on a
``DTensor`` it is ``x.redistribute(mesh, placements)``.  Axis names that
the active mesh does not define are replicated rather than refused, so
one body serves 1-D and 2-D meshes.

The port's model body runs on each rank's local tensors: data
parallelism hands every rank its rows of the batch and reduces the
gradients explicitly (``repro_torch.train.train_step``), an SPMD program
written by hand.  No compiler propagates placements through it, so the
hints the reference puts in its layers would have nothing to act on, and
the port's layers carry none.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["constrain", "mesh_context", "current_mesh"]

_state = threading.local()


def current_mesh():
    """The mesh installed by the innermost ``mesh_context`` (or None)."""
    stack = getattr(_state, "meshes", None)
    return stack[-1] if stack else None


@contextmanager
def mesh_context(mesh):
    """Install ``mesh`` (a ``DeviceMesh``) as the target of ``constrain``."""
    stack = getattr(_state, "meshes", None)
    if stack is None:
        stack = _state.meshes = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def constrain(x, *axes):
    """Hint that dim ``i`` of ``x`` is sharded over mesh axis ``axes[i]``.

    Identity when no mesh is active or ``x`` is not a ``DTensor``.
    Trailing unhinted dims replicate."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from .sharding import placements

    names = set(mesh.mesh_dim_names or ())
    spec = tuple(a if a in names else None for a in axes)
    return x.redistribute(mesh, placements(mesh, spec))
