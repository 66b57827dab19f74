"""Device: the share of the profiled steps' wall time in which no device
operation ran, in %: 100 (1 - busy / wall), busy the union of every
device operation's interval."""


def read(ctx):
    tr = ctx.profile
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
