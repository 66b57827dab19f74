"""Model layers: the device time of the MoE layers' expert products in
an admission, in ms: the ``device_ms`` of the program's ``moe.experts``
regions (the three batched products over every buffer row, the
activation and the product) summed over the layers of each
``serve.prefill`` step inside the window, averaged over those steps,
the profiled steps left out."""

from chipbench import regions


def read(ctx):
    return regions.device_ms_per_step(ctx, "serve.prefill", ("moe.experts",))
