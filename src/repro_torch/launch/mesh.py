"""Device meshes of the port (the port of ``repro.launch.mesh``).

Local: ``make_local_mesh(data, model)`` over the ranks of the running
world, axes ("data", "model") as in production.

Production, H100 nodes (replacing the reference's 16×16 v5e pod): the
``model`` axis is the eight cards of one NVLink node (all to all, 450
GB/s each way) and ``data`` runs across nodes; with ``multi_pod`` a
``pod`` axis goes in front and carries the cross-pod data parallelism,
as in the reference, while ``model`` stays inside a node where links are
fastest.

Functions, not module constants: importing this module touches no device
state and no process group.
"""

from __future__ import annotations

from .._device import group_device_type

__all__ = ["make_production_mesh", "make_local_mesh", "NODE_CARDS", "PODS", "production_shape"]

NODE_CARDS = 8  # H100 cards of one NVLink node: the model axis
PODS = 2  # the multi-pod mesh's pod axis, as in the reference


def production_shape(world: int, *, multi_pod: bool = False):
    """(shape, axis names) of the production mesh over ``world`` cards:
    (nodes, 8) as ("data", "model"), or (2, nodes a pod, 8) with a leading
    "pod" axis."""
    if world % NODE_CARDS:
        raise ValueError(f"{world} cards are not whole nodes of {NODE_CARDS}")
    nodes = world // NODE_CARDS
    if not multi_pod:
        return (nodes, NODE_CARDS), ("data", "model")
    if nodes % PODS:
        raise ValueError(f"{nodes} nodes do not split into {PODS} pods")
    return (PODS, nodes // PODS, NODE_CARDS), ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over every rank of the running world (one
    process a card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = production_shape(dist.get_world_size(), multi_pod=multi_pod)
    return init_device_mesh(group_device_type(), shape, mesh_dim_names=names)


def make_local_mesh(data: int = 1, model: int = 1, device_type: str | None = None):
    """A (data, model) mesh over the ranks of the running world (tests,
    examples, one card) — the same axis names as production.
    ``device_type`` defaults to ``cuda`` on an NCCL group, else ``cpu``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or group_device_type(), (data, model),
                            mesh_dim_names=("data", "model"))
