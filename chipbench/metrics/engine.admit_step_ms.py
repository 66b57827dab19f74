"""Serve engine: the mean wall time of an admission, in ms, from the
program's ``serve.prefill`` spans (the bulk prefill of every slot at
(slots, prefill_pad)) inside the window, the profiled steps left out.
In a closed loop every admission stalls each live row's next token."""


def read(ctx):
    return ctx.span_mean_ms("serve.prefill")
