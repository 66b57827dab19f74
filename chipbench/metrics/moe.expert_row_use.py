"""Model layers: the share of the pair rows computed in an admission
that held a real token copy, in %: over the window's ``serve.prefill``
steps (profiled ones too: they count, not time), 100 x the sum over
each step's ``moe.experts`` regions of the step's ``engine.admit``
``tokens`` times the region's choices a token (``pairs`` / ``tokens``),
over the sum of the regions' ``rows``: the tile rows the grouped
kernels launch, or E x (capacity + 1) where the padded expert buffers
run."""

from chipbench import regions


def read(ctx):
    copies = rows = 0
    for _, held in regions.steps(ctx, "serve.prefill", ("engine.admit", "moe.experts"),
                                 timed=False):
        admitted = sum(r[3]["tokens"] for r in held if r[0] == "engine.admit")
        for r in held:
            if r[0] == "moe.experts" and admitted:
                a = r[3]
                copies += admitted * a["pairs"] // a["tokens"]
                rows += a["rows"]
    return 100.0 * copies / rows if rows else None
