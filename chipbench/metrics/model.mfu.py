"""Model step: useful model FLOPs over the profiled steps' wall time at
the card's peak for the served dtype, in %.  Useful FLOPs are those of
the real prompt tokens admitted and of the tokens decoded in those
steps, through the active parameters and causal attention over each
token's actual context (``costs/model.py``, by the family's own file):
no padded row, no capacity row, no idle slot.  A family without a count
gives nothing to read."""

from chipbench.costs import model, peaks


def read(ctx):
    tr = ctx.profile
    if tr is None:
        return None
    c = ctx.config
    fam = model.family(c["family"], ctx.bench_dir)
    if fam is None:
        ctx.notes.append(f"no FLOP count for family {c['family']}")
        return None
    flops = 0
    for s in ctx.timeline.requests:
        plen = len(s.req.prompt)
        for k, t in enumerate(s.times):
            if not tr.t0 < t <= tr.t1:
                continue
            if k == 0:
                flops += model.prompt_flops(c, fam, plen)
            else:
                flops += fam.token_flops(c, plen + k)
    if flops == 0:
        return None
    return 100.0 * flops / (tr.window_s * peaks.matmul_flops(c["dtype"]))
