"""The program's regions inside its engine steps, for the per-layer readers.

The port records regions (``repro_torch.obs.device_spans``) into the
same trace buffer as its spans: ``moe.dispatch``, ``moe.experts`` and
``moe.combine`` in each MoE layer, ``engine.sample`` and
``engine.admit`` in the engine; a reader names the regions it reads,
another family's layers' too.  Each has the host start and duration of
a span and its attributes; on the card those of an engine step also
carry ``device_ms`` (the stream time between its two events) and
``device_start`` (its device start on the host clock).  A region
belongs to the ``serve.prefill`` or ``serve.decode`` span whose host
interval holds its start.

A program without regions (or a run without a card, for the device
fields) gives these readers nothing to read: each returns None then.
"""

from __future__ import annotations

import bisect


def steps(ctx, name: str, regions: tuple[str, ...],
          timed: bool = True) -> list[tuple[tuple, list[tuple]]]:
    """Each ``name`` span inside the window, with the regions named in
    ``regions`` that it holds, in order; ``timed`` leaves out the profiled
    steps, as ``Context.span_mean_ms`` does."""
    tl, tr = ctx.timeline, ctx.profile

    def unprofiled(s):
        return tr is None or s[1] + s[2] < tr.t0 or s[1] > tr.t1

    spans = sorted((s for s in ctx.spans if s[0] == name and tl.t_open <= s[1]
                    and s[1] + s[2] <= tl.t_close and (unprofiled(s) or not timed)),
                   key=lambda s: s[1])
    held = sorted((s for s in ctx.spans if s[0] in regions), key=lambda s: s[1])
    starts = [s[1] for s in held]
    out = []
    for sp in spans:
        lo = bisect.bisect_left(starts, sp[1])
        hi = bisect.bisect_right(starts, sp[1] + sp[2])
        out.append((sp, held[lo:hi]))
    return out


def device_ms_per_step(ctx, step: str, names: tuple[str, ...]) -> float | None:
    """The regions ``names``' ``device_ms`` summed per ``step`` span (the
    window's, the profiled ones left out), averaged over the steps that
    hold such a region; None where no region has a device time."""
    sums = []
    for _, held in steps(ctx, step, names):
        ms = [r[3]["device_ms"] for r in held if "device_ms" in (r[3] or {})]
        if ms:
            sums.append(sum(ms))
    return sum(sums) / len(sums) if sums else None


def host_ms_per_step(ctx, step: str, name: str) -> float | None:
    """Region ``name``'s host duration summed per ``step`` span (the
    window's, the profiled ones left out), averaged over the steps that
    hold one; None where none does."""
    sums = []
    for _, held in steps(ctx, step, (name,)):
        durs = [r[2] for r in held]
        if durs:
            sums.append(1e3 * sum(durs))
    return sum(sums) / len(sums) if sums else None


def overlap_s(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals (in their own unit)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total
