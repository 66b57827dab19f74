"""SPMD bodies for traced-run tests, launched via
``pRUN('repro_torch.obs._selftest:fn', np, ...)`` with ``PPYTHON_TRACE=1``.

Each body mixes point-to-point traffic (so every rank records
``comm.send``/``comm.recv`` spans with peer/bytes/fabric attribution),
a collective, and a visible compute span; the merged Chrome trace is
written by the pRUN worker's automatic ``merge_traces`` at shutdown.
"""

from __future__ import annotations

import numpy as np

from repro_torch.comm import get_context
from repro_torch.obs import instant, span


def _spin(seconds: float) -> int:
    """Busy-wait compute filler that the tracer can see around comm."""
    import time

    n = 0
    t0 = time.perf_counter()
    with span("compute.spin", budget_s=seconds):
        while time.perf_counter() - t0 < seconds:
            n += 1
    return n


def traced_ring() -> float:
    """Ring exchange + allreduce + barrier under tracing.

    Every rank sends to its successor and receives from its
    predecessor — on HierComm with virtual nodes this exercises both
    the shm (same-node neighbour) and tcp (node-boundary) fabrics.
    """
    ctx = get_context()
    me, world = ctx.pid, ctx.np_
    instant("app.start", rank=me)
    payload = np.full(1024, float(me))
    total = 0.0
    for rep in range(3):
        ctx.send((me + 1) % world, ("ring", rep), payload)
        got = ctx.recv((me - 1) % world, ("ring", rep))
        total += float(got.sum())
        _spin(0.002)
    s = sum(ctx.allgather(total))
    ctx.barrier()
    return float(s)


def traced_all_pairs() -> int:
    """Every rank sends one message to every other rank (and receives
    one from each), so the fabric attribution of *all* peer pairs shows
    up in the merged trace."""
    ctx = get_context()
    me, world = ctx.pid, ctx.np_
    blob = np.arange(256, dtype=np.float64) * (me + 1)
    for peer in range(world):
        if peer != me:
            ctx.send(peer, ("pair", me, peer), blob)
    n = 0
    for peer in range(world):
        if peer != me:
            got = ctx.recv(peer, ("pair", peer, me))
            n += got.size
    _spin(0.001)
    ctx.barrier()
    return n
