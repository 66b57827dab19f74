"""Serve engine: the mean wall time of a decode step, in ms, from the
program's ``serve.decode`` spans (a host clock around the step, which
ends in the step's one device-to-host copy) inside the window, the
profiled steps left out."""


def read(ctx):
    return ctx.span_mean_ms("serve.decode")
