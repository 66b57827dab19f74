"""Model layers: the device time of the MoE layers' dispatch in an
admission, in ms: the ``device_ms`` of the program's ``moe.dispatch``
regions (route, sort, the expert buffers' zero-fill and scatter) summed
over the layers of each ``serve.prefill`` step inside the window,
averaged over those steps, the profiled steps left out."""

from chipbench import regions


def read(ctx):
    return regions.device_ms_per_step(ctx, "serve.prefill", ("moe.dispatch",))
