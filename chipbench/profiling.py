"""The traced run's device trace, bounded to a fixed run of engine steps.

``Profiler`` runs ``torch.profiler`` (CUDA activity only: no host op is
recorded, so the host's pace is the untraced one but for the tracer's
own hooks) over window steps ``profile.skip`` to ``profile.skip +
profile.steps - 1`` (started one step early), keeps the device events
the host launched within them, places them on the host clock (the map
corrected so that each step's one device-to-host copy ends with its
span), and meanwhile wraps the
functions the metric readers name in their ``hooks`` to record each
call's argument shapes.  No trace file is written.

``Trace`` is what a per-layer reader gets under ``ctx.profile``: every
device event (kernels, copies, sets) of the profiled steps on the
profiler's clock (ns since the epoch), the steps' range on the host
clock (``time.perf_counter``) and the map between the two, the recorded
calls, and the program's spans (``repro_torch.obs.trace``).
"""

from __future__ import annotations

import bisect
import importlib
import re
import time

import torch


def _arg(v):
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype).removeprefix("torch."))
    return v if isinstance(v, (int, float, bool, str, type(None))) else repr(v)


class _Hooks:
    """Wraps ``module.attr`` callables to record ``(args, kwargs)`` of each
    call under ``"module.attr"`` while installed."""

    def __init__(self, targets):
        self.targets = sorted(set(targets))
        self.calls: dict[str, list] = {f"{m}.{a}": [] for m, a in self.targets}
        self._saved = []

    def install(self):
        for mod_name, attr in self.targets:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            log = self.calls[f"{mod_name}.{attr}"]

            def wrapped(*args, _fn=fn, _log=log, **kw):
                _log.append((tuple(_arg(a) for a in args),
                             {k: _arg(v) for k, v in kw.items()}))
                return _fn(*args, **kw)

            setattr(mod, attr, wrapped)
            self._saved.append((mod, attr, fn))

    def remove(self):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []


class Trace:
    def __init__(self, events, t0, t1, offset_ns, calls, spans):
        self.events = sorted(events, key=lambda e: e[1])  # (name, start_ns, end_ns)
        self.t0, self.t1 = t0, t1  # the profiled steps, host clock
        self.offset_ns = offset_ns  # epoch ns - perf_counter ns
        self.calls = calls
        self.spans = spans  # (name, start, dur, attrs), host clock

    def ns(self, t: float) -> float:
        """A host-clock time on the profiler's clock."""
        return t * 1e9 + self.offset_ns

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def intervals(self, lo_ns: float, hi_ns: float) -> list[tuple[float, float]]:
        """The union of the device events' intervals, clipped to [lo, hi]."""
        out: list[list[float]] = []
        for _, a, b in self.events:
            a, b = max(a, lo_ns), min(b, hi_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self, t0: float | None = None, t1: float | None = None) -> float:
        """Seconds in which some device operation ran, within [t0, t1]
        (host clock; the profiled steps by default)."""
        lo = self.ns(self.t0 if t0 is None else t0)
        hi = self.ns(self.t1 if t1 is None else t1)
        return sum(b - a for a, b in self.intervals(lo, hi)) * 1e-9

    def kernels(self, pattern: re.Pattern) -> list[tuple[str, float, float]]:
        """The device events whose name matches ``pattern``, in order."""
        return [e for e in self.events if pattern.search(e[0])]

    def profiled_spans(self, name: str) -> list[tuple]:
        return [s for s in self.spans if s[0] == name and self.t0 <= s[1]
                and s[1] + s[2] <= self.t1]


class Profiler:
    """Starts and stops the device trace around a cell's profiled steps."""

    def __init__(self, skip: int, steps: int, hook_targets, driver):
        self.skip, self.steps = int(skip), int(steps)
        self.hooks = _Hooks(hook_targets)
        self.driver = driver
        self.prof = None
        self.first = self.last = None
        self.offset_ns = None
        self.shift_ns = 0.0
        self.events = None
        self.launched: dict[int, int] = {}

    @staticmethod
    def warm_up(fn) -> None:
        """Run ``fn`` once under the profiler, so that CUPTI's start-up is
        paid in set-up."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()

    def before_step(self, i: int) -> None:
        """The profiler starts a step early (that step is not read: the
        tracer's first launches may go unrecorded while it starts); the
        hooks and the profiled range start at step ``skip``."""
        if i == max(0, self.skip - 1) and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            a = time.time_ns()
            p = time.perf_counter_ns()
            b = time.time_ns()
            self.offset_ns = (a + b) / 2 - p
        if i == self.skip:
            self.hooks.install()
            self.first = len(self.driver.steps)

    def after_step(self, i: int) -> None:
        if i == self.skip + self.steps - 1:
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.events is not None or self.first is None:
            return
        self.last = len(self.driver.steps) - 1
        self.hooks.remove()
        torch.cuda.synchronize()
        self.prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        launched: dict[int, int] = {}  # correlation id -> host time of its runtime call
        self.events = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                self.events.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                                    e.correlation_id()))
            elif e.correlation_id():
                c = e.correlation_id()
                launched[c] = min(launched.get(c, e.start_ns()), e.start_ns())
        self.launched = launched

    def trace(self, spans) -> Trace | None:
        self.stop()
        if self.events is None or self.last < self.first:
            if self.prof is not None and self.events is None:
                self.prof.stop()  # the window closed before step ``skip``
            return None
        t0, t1 = self.driver.steps[self.first][0], self.driver.steps[self.last][1]
        self.shift_ns = _copy_shift(self.events, spans, self.offset_ns)
        offset = self.offset_ns + self.shift_ns
        # an operation belongs to the profiled steps if the host launched it
        # within them (both on the host's clock); one whose launch the
        # profiler did not record, if it ran within them on the device clock
        lo, hi = t0 * 1e9 + self.offset_ns, t1 * 1e9 + self.offset_ns
        events = []
        for name, a, b, corr in self.events:
            at = self.launched.get(corr)
            if (lo <= at <= hi) if at is not None else (lo <= a + self.shift_ns
                                                          and b + self.shift_ns <= hi):
                events.append((name, a, b))
        return Trace(events, t0, t1, offset, self.hooks.calls, spans)


def _copy_shift(events, spans, offset_ns: float, reach_ns: float = 30e6) -> float:
    """The correction to the clock map that puts each engine step's last
    device-to-host copy (its one host copy, which the step's span waits
    for) at the end of the step's span: the median over the steps of the
    nearest copy's distance, within ``reach_ns``; 0 without copies.  The
    profiler's map of device time to the host clock can be off by
    milliseconds; the span ends lie within tens of microseconds of their
    copies."""
    ends = sorted(e[2] for e in events if e[0].startswith("Memcpy DtoH"))
    if not ends:
        return 0.0
    diffs = []
    for name, start, dur, _ in spans:
        if name not in ("serve.decode", "serve.prefill"):
            continue
        end = (start + dur) * 1e9 + offset_ns
        k = bisect.bisect_left(ends, end)
        near = min((ends[j] for j in (k - 1, k) if 0 <= j < len(ends)),
                   key=lambda c: abs(c - end))
        if abs(near - end) <= reach_ns:
            diffs.append(near - end)
    return float(sorted(diffs)[len(diffs) // 2]) if diffs else 0.0


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing (inside which program span, or between
    steps), with the longest single gaps."""
    by_name: dict[str, float] = {}
    for name, a, b in tr.events:
        short = re.sub(r"^void |\(anonymous namespace\)::", "", name).split("(")[0][:120]
        by_name[short] = by_name.get(short, 0.0) + (b - a) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = tr.ns(tr.t0), tr.ns(tr.t1)
    busy = tr.intervals(lo, hi)
    gaps = [(a, b) for a, b in zip([lo] + [e for _, e in busy], [s for s, _ in busy] + [hi])
            if b > a]
    spans = sorted((tr.ns(s[1]), tr.ns(s[1] + s[2]), s[0]) for s in tr.spans
                   if s[2] > 0 and s[0].startswith("serve."))
    starts = [s for s, _, _ in spans]
    idle: dict[str, float] = {}
    single = []
    for a, b in gaps:
        k = bisect.bisect_right(starts, a) - 1
        inside = k >= 0 and b <= spans[k][1]
        label = (f"in {spans[k][2]} (host work between device ops)" if inside
                 else "between engine steps (scheduler, benchmark)")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
        single.append((label, (b - a) * 1e-9))
    rows = sorted(idle.items(), key=lambda kv: -kv[1])
    longest = sorted(single, key=lambda x: -x[1])[: max(0, top - len(rows))]
    rows += [(f"longest single gap {label}", s) for label, s in longest]
    return {"device_ops": [list(r) for r in ops], "idle_gaps": [list(r) for r in rows[:top]]}
