"""Kernels: ``csrc/ssd_scan.cu``'s share of its roofline over the profiled
steps, in %: the sum over its launches of the least time the card could
take (``costs/kernels.py``'s frozen count at each call's shape, with B
and C read once for each of their groups: 2 e b s (G - 1) N bytes more
than its one group) over the sum of their device times.  Launches are
the device events named as the kernel compiles (``ssd_mma_kernel<...>``,
``ssd_kernel<...>``); shapes from the calls into
``repro_torch.kernels.ops.ssd``."""

import re

from chipbench.costs import kernels

NAME = re.compile(r"^(void )?(\(anonymous namespace\)::)?ssd_(mma_)?kernel<")
hooks = [("repro_torch.kernels.ops", "ssd")]


def cost(b: int, s: int, h: int, p: int, n: int, chunk: int, groups: int,
         dtype: str = "bfloat16") -> dict:
    """One call's work: the frozen one-group count, B and C once more for
    each further group."""
    out = kernels.ssd_scan(b, s, h, p, n, chunk, dtype)
    out["bytes"] += 2 * kernels.BYTES[dtype] * b * s * (groups - 1) * n
    return out


def read(ctx):
    def bound(args, kw):
        (x, dtype), (bm, _) = args[0], args[3]
        b, s, h, p = x
        groups = bm[2] if len(bm) == 4 else 1
        return kernels.bound_s(cost(b, s, h, p, bm[-1], kw.get("chunk", 64), groups, dtype),
                               dtype)

    return ctx.roofline(NAME, "repro_torch.kernels.ops.ssd", bound)
