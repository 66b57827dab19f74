"""Serve engine: the host time of sampling in a decode step, in ms: the
host duration of the program's ``engine.sample`` region (the greedy
argmax of every row, and a ``torch.rand`` and its Gumbel-max for each
row drawn at a temperature) in each ``serve.decode`` step inside the
window, averaged over those steps, the profiled steps left out."""

from chipbench import regions


def read(ctx):
    return regions.host_ms_per_step(ctx, "serve.decode", "engine.sample")
