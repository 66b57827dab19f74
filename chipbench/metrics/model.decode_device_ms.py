"""Model step: the device's busy time (the union of every device
operation's interval) inside each profiled ``serve.decode`` span, in ms,
averaged over those steps.  Beside ``engine.decode_step_ms`` the rest
is the host-bound part of a decode step."""


def read(ctx):
    tr = ctx.profile
    if tr is None:
        return None
    spans = tr.profiled_spans("serve.decode")
    if not spans:
        return None
    return 1e3 * sum(tr.busy_s(s[1], s[1] + s[2]) for s in spans) / len(spans)
