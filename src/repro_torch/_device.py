"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises rather than fall back.

    Entry points default to ``"cuda"``; asking for it on a machine
    without a card is an error, never a silent move to the CPU.
    """
    dev = torch.device(device)
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
