"""Drive the port's continuous-batching engine with a cell's traffic and
record when every token came.

The engine (``repro_torch.serve.engine.ContinuousBatchingEngine``) gets
the generated requests through ``submit`` and runs through ``step``;
this module keeps the clock.  A request's first token is timed by the
engine (``first_token_t``, the end of its admission); every later token
at the return of the ``step`` that produced it.  A request is due when
its client sends it: in a closed loop the moment the client's previous
request finished (its ``finish_t``), in an open loop at its scheduled
time, whatever the engine is doing.

The window opens once every slot has been filled (closed loop: after
the step that admits the clients' first requests; open loop:
``warm_s`` after the traffic starts) and closes ``seconds`` later.
Stepping goes on past the close until every request due inside the
window has its first token, for at most ``GRACE_S``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.serve.scheduler import QueueFull

from .traffic import Req, Traffic

GRACE_S = 60.0


@dataclass
class Served:
    req: Req
    due: float  # the host clock (time.perf_counter) when it was sent
    handle: object = None  # the engine's Request
    times: list[float] = field(default_factory=list)  # one per output token
    rejected: bool = False

    @property
    def first(self) -> float | None:
        return self.times[0] if self.times else None

    @property
    def finished(self) -> bool:
        return self.handle is not None and self.handle.done


@dataclass
class Timeline:
    """What the end-to-end readers read.  Times are ``perf_counter``
    seconds; ``steps`` holds each engine step's (start, end)."""

    t_open: float
    t_close: float
    setup_s: float
    peak_bytes: int = 0
    requests: list[Served] = field(default_factory=list)
    steps: list[tuple[float, float]] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def due_in_window(self) -> list[Served]:
        return [s for s in self.requests if self.t_open <= s.due < self.t_close]


class Driver:
    """Runs one cell's traffic through ``engine``.  ``before_step(i)`` and
    ``after_step(i)`` are called around the i-th step of the window (i
    from 0); ``on_open()`` when the window opens."""

    def __init__(self, engine, traffic: Traffic):
        self.eng = engine
        self.traffic = traffic
        self.clock = time.perf_counter
        self.served: list[Served] = []
        self._live: list[Served] = []
        self.steps: list[tuple[float, float]] = []

    def _submit(self, r: Req, due: float) -> Served:
        s = Served(req=r, due=due)
        self.served.append(s)
        try:
            s.handle = self.eng.submit(r.prompt, max_new=r.max_new, temperature=r.temperature,
                                       seed=r.seed, arrival_t=due)
        except QueueFull:
            s.rejected = True
            return s
        self._live.append(s)
        return s

    def _step(self) -> list:
        t0 = self.clock()
        finished = self.eng.step()
        t = self.clock()
        self.steps.append((t0, t))
        still = []
        for s in self._live:
            h = s.handle
            new = len(h.tokens) - len(s.times)
            if new > 0:
                if not s.times:
                    s.times.append(h.first_token_t)
                    new -= 1
                s.times.extend([t] * new)
            if not h.done:
                still.append(s)
        self._live = still
        return finished

    def run(self, seconds: float, t_start: float, before_step=None, after_step=None,
            on_open=None) -> Timeline:
        """Serve for ``seconds`` from the window's opening; ``t_start`` is
        the process start (for ``setup_s``)."""
        closed = self.traffic.loop["kind"] == "closed"
        by_handle: dict[int, Served] = {}
        pending: list[Req] = []
        t_traffic = self.clock()
        if closed:
            for r in self.traffic.first_requests():
                s = self._submit(r, self.clock())
                by_handle[id(s.handle)] = s
        else:
            warm = float(self.traffic.loop.get("warm_s", 0.0))
            pending = self.traffic.schedule(warm + seconds)
        t_open = None
        if not closed:
            t_open = t_traffic + float(self.traffic.loop.get("warm_s", 0.0))
        i = 0
        while True:
            now = self.clock()
            if not closed:
                while pending and t_traffic + pending[0].due <= now:
                    r = pending.pop(0)
                    self._submit(r, t_traffic + r.due)
                if not self._live:
                    if not pending:
                        break
                    time.sleep(max(0.0, t_traffic + pending[0].due - now))
                    continue
            if t_open is not None and now >= t_open and on_open is not None:
                on_open()
                on_open = None
            in_window = t_open is not None and now >= t_open
            if in_window and before_step is not None:
                before_step(i)
            finished = self._step()
            if in_window:
                if after_step is not None:
                    after_step(i)
                i += 1
            if closed:
                for h in finished:
                    prev = by_handle.pop(id(h))
                    s = self._submit(self.traffic.next_request(prev.req), h.finish_t)
                    by_handle[id(s.handle)] = s
                if t_open is None:
                    t_open = self.clock()
                    if on_open is not None:
                        on_open()
                        on_open = None
            t = self.clock()
            if t_open is not None and t >= t_open + seconds:
                close = t_open + seconds
                late = [s for s in self.served if s.due < close and not s.times
                        and not s.rejected]
                if not late or t >= close + GRACE_S:
                    break
        return Timeline(t_open=t_open, t_close=t_open + seconds, setup_s=t_open - t_start,
                        requests=self.served, steps=self.steps)
