"""Seconds from the start of the benchmark's process to the opening of
the window: imports, the kernels' build or load, the weights, the
warm-up of the cell's shapes and the first admission of its traffic."""


def read(ctx):
    return ctx.timeline.setup_s
