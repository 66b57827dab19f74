"""Model layers: the device time of the SSD scans in an admission, in ms:
the ``device_ms`` of the program's ``mamba.ssd`` regions (the chunked
scan inside each Mamba2 mixer) summed over the layers of each
``serve.prefill`` step inside the window, averaged over those steps, the
profiled steps left out."""

from chipbench import regions


def read(ctx):
    return regions.device_ms_per_step(ctx, "serve.prefill", ("mamba.ssd",))
