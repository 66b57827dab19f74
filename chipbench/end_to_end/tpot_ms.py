"""Every gap between consecutive output tokens of one request that lies
inside the window: their total time over their count, in ms.  A step
that admits stalls each live row's next token, so admissions count."""


def read(ctx):
    tl = ctx.timeline
    gaps = [b - a for s in tl.requests for a, b in zip(s.times, s.times[1:])
            if tl.t_open <= a and b <= tl.t_close]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
