"""Serve engine: the share of an admission's prefilled positions that
held a real prompt token, in %: over the program's ``engine.admit``
regions in the window's ``serve.prefill`` steps (profiled ones too:
they count, not time), 100 x the sum of ``tokens`` (the prompt tokens
admitted) over the sum of ``positions`` (slots x ``prefill_pad``)."""

from chipbench import regions


def read(ctx):
    tokens = positions = 0
    for _, held in regions.steps(ctx, "serve.prefill", ("engine.admit",), timed=False):
        for r in held:
            tokens += r[3]["tokens"]
            positions += r[3]["positions"]
    return 100.0 * tokens / positions if positions else None
