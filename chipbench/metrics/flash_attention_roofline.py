"""Kernels: ``csrc/flash_attention.cu``'s share of its roofline over the
profiled steps, in %: the sum over its launches of the least time the
card could take (``costs/kernels.py``, at each call's shape) over the
sum of their device times.  Launches are the device events named as
the kernel compiles (``flash_bf16_kernel<...>``, ``flash_f32_kernel<...>``);
shapes from the calls into ``repro_torch.kernels.ops.flash_attention``."""

import re

from chipbench.costs import kernels

NAME = re.compile(r"^(void )?(\(anonymous namespace\)::)?flash_(bf16|f32)_kernel<")
hooks = [("repro_torch.kernels.ops", "flash_attention")]


def read(ctx):
    def bound(args, kw):
        (q, dtype), (k, _) = args[0], args[1]
        b, s, h, d = q
        cost = kernels.flash_attention(b, s, h, k[2], d, causal=kw.get("causal", True),
                                       dtype=dtype)
        return kernels.bound_s(cost, dtype)

    return ctx.roofline(NAME, "repro_torch.kernels.ops.flash_attention", bound)
