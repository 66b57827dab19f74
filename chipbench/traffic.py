"""The traffic generator: one for every cell, driven by the cell's file.

A cell's ``loop`` is ``{"kind": "closed", "clients": C}`` (each client
sends its next request the moment its previous one finishes) or
``{"kind": "open", "rate": r, "burst": {"every_s": t, "size": k}}``
(requests due on a schedule whatever the engine does; ``burst``
optional).  ``prompt_len`` and ``output_len`` are ``{"dist": "uniform" |
"log_uniform", "lo": a, "hi": b}`` over whole numbers.  Every
``1 / sampled_share``-th request samples at ``temperature``; the rest are
greedy.

Every seed gets the same work in another order.  Request ``n``'s lengths
are quantiles of the cell's distributions at the points of two Weyl
sequences, ``frac(1/2 + n g)``, so they follow the distributions as
closely as a stratified sample does and do not depend on the seed.  In
a closed loop client ``c`` sends requests ``c, c + C, c + 2C, ...``, and
its first request's output length is the residual of the output
distribution (the length left at a random point of a request: P(R = r)
= P(L >= r) / E[L]) at the stratified point ``(c + 1/2) / C``, so the
slots finish out of step from the start.  The seed draws the prompts'
token ids, the sampled requests' seeds and the order in which the
clients first submit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

PROMPT_STEP = (math.sqrt(5.0) - 1.0) / 2.0  # Weyl steps: irrational and far apart
OUTPUT_STEP = math.sqrt(2.0) - 1.0
GAP_STEP = math.sqrt(3.0) - 1.0


@dataclass
class Req:
    """One request as the benchmark sends it.  ``due`` is in seconds from
    the start of the traffic in an open loop; a closed loop sets it when
    the client's previous request finishes."""

    index: int
    client: int
    prompt: list[int]
    max_new: int
    temperature: float
    seed: int
    due: float | None = None


def weyl(n: int, step: float) -> float:
    return (0.5 + n * step) % 1.0


def length_at(dist: dict, u: float) -> int:
    """The quantile of a length distribution at ``u`` in [0, 1)."""
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if dist["dist"] == "uniform":
        return lo + min(int(u * (hi - lo + 1)), hi - lo)
    if dist["dist"] == "log_uniform":
        v = math.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
        return min(max(int(v), lo), hi)
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def pmf(dist: dict) -> np.ndarray:
    """P(L = l) for l = 0..hi, as ``length_at`` draws it."""
    lo, hi = int(dist["lo"]), int(dist["hi"])
    p = np.zeros(hi + 1)
    if dist["dist"] == "uniform":
        p[lo:] = 1.0 / (hi - lo + 1)
        return p
    a, b = math.log(lo), math.log(hi + 1)
    for v in range(lo, hi + 1):  # int(exp(.)) lands on v for exp(.) in [v, v+1)
        p[v] = (math.log(v + 1) - math.log(v)) / (b - a)
    return p / p.sum()


def residual_at(dist: dict, u: float) -> int:
    """The quantile at ``u`` of the residual length R >= 1 of ``dist``."""
    p = pmf(dist)
    tail = p[::-1].cumsum()[::-1]  # P(L >= r)
    q = tail[1:] / (np.arange(len(p)) * p).sum()  # P(R = r), r = 1..hi
    return int(np.searchsorted(q.cumsum(), u * q.sum(), side="right")) + 1


def sampled(n: int, share: float) -> bool:
    """Whether request ``n`` samples: every ``1/share``-th, evenly spread."""
    return math.floor((n + 1) * share) > math.floor(n * share)


class Traffic:
    """The requests of one cell under one seed."""

    def __init__(self, cell: dict, vocab: int, seed: int):
        self.cell = cell
        self.loop = cell["loop"]
        self.vocab = vocab
        self.seed = int(seed) % 2**63
        self.share = float(cell.get("sampled_share", 0.0))
        self.temperature = float(cell.get("temperature", 0.0))

    def request(self, n: int, client: int = 0, max_new: int | None = None) -> Req:
        rng = np.random.default_rng([self.seed, n])
        plen = length_at(self.cell["prompt_len"], weyl(n, PROMPT_STEP))
        if max_new is None:
            max_new = length_at(self.cell["output_len"], weyl(n, OUTPUT_STEP))
        temp = self.temperature if sampled(n, self.share) else 0.0
        return Req(index=n, client=client,
                   prompt=rng.integers(0, self.vocab, size=plen).tolist(),
                   max_new=max_new, temperature=temp,
                   seed=int(rng.integers(0, 2**62)))

    # -- closed loop -------------------------------------------------------

    @property
    def clients(self) -> int:
        return int(self.loop["clients"])

    def first_requests(self) -> list[Req]:
        """Each client's first request, in the seed's submission order."""
        c = self.clients
        order = np.random.default_rng([self.seed, 2**32]).permutation(c)
        return [self.request(int(k), client=int(k),
                             max_new=residual_at(self.cell["output_len"], (k + 0.5) / c))
                for k in order]

    def next_request(self, prev: Req) -> Req:
        """The request a client sends once ``prev`` finishes."""
        return self.request(prev.index + self.clients, client=prev.client)

    # -- open loop ---------------------------------------------------------

    def schedule(self, horizon_s: float) -> list[Req]:
        """Every request due in the first ``horizon_s`` seconds: Poisson
        gaps at ``rate`` (exponential quantiles at a Weyl sequence), plus
        ``burst.size`` requests due together every ``burst.every_s``."""
        rate = float(self.loop["rate"])
        due = []
        t, k = 0.0, 0
        while True:
            t += -math.log(1.0 - weyl(k, GAP_STEP)) / rate
            k += 1
            if t >= horizon_s:
                break
            due.append(t)
        burst = self.loop.get("burst")
        if burst:
            every, size = float(burst["every_s"]), int(burst["size"])
            due += [j * every for j in range(1, int(horizon_s / every) + 1)
                    if j * every < horizon_s for _ in range(size)]
        out = []
        for n, d in enumerate(sorted(due)):
            r = self.request(n)
            r.due = d
            out.append(r)
        return out
