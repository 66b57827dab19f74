"""Device: the device's idle time inside a profiled decode step while
the host was inside one of the MoE layers' regions, in ms: over the
profiled ``serve.decode`` spans, the time in which no device operation
ran (the gaps between the union of the device events' intervals) that
falls within the host interval of a ``moe.dispatch``, ``moe.experts``
or ``moe.combine`` region of the step, averaged over the steps.  The
idle time of the decode step charged to the host's MoE work."""

import bisect

from chipbench import regions


def read(ctx):
    tr = ctx.profile
    if tr is None:
        return None
    steps = sorted(tr.profiled_spans("serve.decode"), key=lambda s: s[1])
    starts = [s[1] for s in steps]
    moe = []
    for name, t0, dur, _ in sorted(ctx.spans, key=lambda s: s[1]):
        k = bisect.bisect_right(starts, t0) - 1
        if name.startswith("moe.") and k >= 0 and t0 + dur <= steps[k][1] + steps[k][2]:
            moe.append((tr.ns(t0), tr.ns(t0 + dur)))
    if not steps or not moe:
        return None
    lo, hi = tr.ns(tr.t0), tr.ns(tr.t1)
    busy = tr.intervals(lo, hi)
    gaps = [(a, b) for a, b in zip([lo] + [e for _, e in busy], [s for s, _ in busy] + [hi])
            if b > a]
    return regions.overlap_s(gaps, moe) * 1e-6 / len(steps)
