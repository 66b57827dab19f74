"""Output tokens the engine produced inside the window, over its seconds."""


def read(ctx):
    tl = ctx.timeline
    n = sum(1 for s in tl.requests for t in s.times if tl.t_open <= t <= tl.t_close)
    return n / tl.seconds
