"""The 90th percentile of time to first token, in ms, over every request
due inside the window, each timed from the moment it was due."""

import statistics


def read(ctx):
    xs = [s.first - s.due for s in ctx.timeline.due_in_window() if s.times]
    if len(xs) < 2:
        return None
    return 1e3 * statistics.quantiles(xs, n=10, method="inclusive")[8]
