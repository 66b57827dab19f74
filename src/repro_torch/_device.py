"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device, allow_meta: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; raises rather than fall back.

    Entry points default to ``"cuda"``; asking for it on a machine
    without a card is an error, never a silent move to the CPU.  With
    ``allow_meta``, ``"meta"`` (shapes and dtypes, no storage) is taken
    too: the placement trees of ``repro_torch.dist`` are built on it.
    """
    dev = torch.device(device)
    if allow_meta and dev.type == "meta":
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type == "cuda" and dev.index is None:  # as tensors report it
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def group_device_type() -> str:
    """The device type of the running process group's tensors: ``cuda``
    on NCCL, ``cpu`` on gloo."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"
