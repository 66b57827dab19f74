"""Kernels: ``csrc/rmsnorm.cu``'s share of its roofline over the profiled
steps, in %: the sum over its launches of the least time the card could
take (``costs/kernels.py``, at each call's shape) over the sum of their
device times.  Launches are the device events named as the kernel
compiles (``rmsnorm_vec_kernel<...>``, ``rmsnorm_scalar_kernel<...>``);
shapes from the calls into ``repro_torch.kernels.ops.rmsnorm``."""

import re

from chipbench.costs import kernels

NAME = re.compile(r"^(void )?(\(anonymous namespace\)::)?rmsnorm_(vec|scalar)_kernel<")
hooks = [("repro_torch.kernels.ops", "rmsnorm")]


def read(ctx):
    def bound(args, kw):
        (m, d), dtype = args[0]
        return kernels.bound_s(kernels.rmsnorm(m, d, dtype), dtype)

    return ctx.roofline(NAME, "repro_torch.kernels.ops.rmsnorm", bound)
