"""Model layers: the device time of the shared attention blocks in an
admission, in ms: the ``device_ms`` of the program's ``hybrid.shared``
regions (one a use of a shared block: the concatenated input's norm,
attention, the norm, the adapted MLP and the use's linear) summed over
each ``serve.prefill`` step inside the window, averaged over those steps,
the profiled steps left out."""

from chipbench import regions


def read(ctx):
    return regions.device_ms_per_step(ctx, "serve.prefill", ("hybrid.shared",))
