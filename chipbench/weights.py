"""The weights, drawn by the benchmark from the seed on the device.

The tree and each leaf's shape and dtype are the program's
(``abstract_params``); the values are the benchmark's own, drawn in
three calls on the device's generator: one normal draw for every leaf of
the served dtype, one normal and one uniform draw for the fp32 leaves.
Each leaf is a view of its draw, scaled in place:

* a matrix: N(0, 1 / fan-in), the fan-in its second-last dim; the
  embedding N(0, 1);
* a norm weight (the rms weight is ``1 + w``) and any other fp32 leaf:
  N(0, 0.1^2);
* Mamba2's ``A_log``: log U[1, 16]; ``dt_bias``: the inverse softplus of
  a step log-uniform in [1e-3, 1e-1]; ``D_skip``: U[0.5, 1.5].

The engine and the plain reference read the same tensors.
"""

from __future__ import annotations

import math

import torch


def _leaves(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _put(tree: dict, path: str, value: torch.Tensor) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def draw(abstract: dict, seed: int, device) -> dict:
    """A tree of tensors shaped as ``abstract`` (meta tensors), drawn from
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    leaves = list(_leaves(abstract))
    wide = [(p, t) for p, t in leaves if t.dtype == torch.float32]
    narrow = [(p, t) for p, t in leaves if t.dtype != torch.float32]
    dtypes = {t.dtype for _, t in narrow}
    if len(dtypes) > 1:
        raise ValueError(f"more than one served dtype: {dtypes}")
    out: dict = {}
    if narrow:
        n = sum(t.numel() for _, t in narrow)
        flat = torch.randn(n, generator=gen, dtype=dtypes.pop(), device=device)
        at = 0
        for path, t in narrow:
            v = flat[at: at + t.numel()].view(t.shape)
            at += t.numel()
            if path != "embed" and v.dim() >= 2:
                v.mul_(1.0 / math.sqrt(t.shape[-2]))
            elif v.dim() < 2:
                v.mul_(0.1)
            _put(out, path, v)
    n = sum(t.numel() for _, t in wide)
    z = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    u = torch.rand(n, generator=gen, dtype=torch.float32, device=device)
    at = 0
    for path, t in wide:
        zs = z[at: at + t.numel()].view(t.shape)
        us = u[at: at + t.numel()].view(t.shape)
        at += t.numel()
        name = path.rsplit("/", 1)[-1]
        if name == "A_log":
            v = torch.log(1.0 + 15.0 * us)
        elif name == "dt_bias":
            dt = torch.exp(math.log(1e-3) + us * (math.log(1e-1) - math.log(1e-3)))
            v = torch.log(torch.expm1(dt))
        elif name == "D_skip":
            v = 0.5 + us
        else:
            v = zs.mul_(0.1)
        _put(out, path, v)
    return out
