"""Model layers: the device time of the Mamba2 mixers in an admission, in
ms: the ``device_ms`` of the program's ``mamba.mixer`` regions (in_proj,
the causal conv, the SSD scan, the gated norm and out_proj of one layer)
summed over the layers of each ``serve.prefill`` step inside the window,
averaged over those steps, the profiled steps left out."""

from chipbench import regions


def read(ctx):
    return regions.device_ms_per_step(ctx, "serve.prefill", ("mamba.mixer",))
