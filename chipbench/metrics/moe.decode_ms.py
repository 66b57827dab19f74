"""Model layers: the stream time of the MoE layers in a decode step, in
ms: the ``device_ms`` of the program's ``moe.dispatch``, ``moe.experts``
and ``moe.combine`` regions summed over the layers of each
``serve.decode`` step inside the window, averaged over those steps, the
profiled steps left out.  A region's stream time runs from its first
event to its last, so in a step bound by the host it includes the
device's waits for the host's launches."""

from chipbench import regions


def read(ctx):
    return regions.device_ms_per_step(ctx, "serve.decode",
                                      ("moe.dispatch", "moe.experts", "moe.combine"))
