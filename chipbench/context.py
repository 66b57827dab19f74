"""What a metric reader gets: ``read(ctx)``.

``ctx.timeline`` (``serve.Timeline``) holds every request's due time and
token times and the window; ``ctx.config`` the configuration's file;
``ctx.cell`` the cell; ``ctx.spans`` the program's spans
(``repro_torch.obs.trace`` events ``(name, start, dur, attrs)``, host
clock) in a traced run; ``ctx.profile`` the device trace of the
profiled steps (``profiling.Trace``) or None; ``ctx.bench_dir`` the
checkout's benchmark folder, where a reader finds a file by name;
``ctx.notes`` what the readers say of a metric left out.
"""

from __future__ import annotations

from pathlib import Path

from .spec import PKG, ROOT


class Context:
    def __init__(self, timeline, config: dict, cell: dict, spans=(), profile=None,
                 bench_dir: Path = ROOT / PKG):
        self.timeline = timeline
        self.config = config
        self.cell = cell
        self.spans = list(spans)
        self.profile = profile
        self.bench_dir = Path(bench_dir)
        self.notes: list[str] = []

    def span_mean_ms(self, name: str) -> float | None:
        """The mean duration in ms of the program's ``name`` spans inside
        the window, leaving out those of the profiled steps."""
        tl, tr = self.timeline, self.profile
        durs = [s[2] for s in self.spans if s[0] == name and tl.t_open <= s[1]
                and s[1] + s[2] <= tl.t_close
                and (tr is None or s[1] + s[2] < tr.t0 or s[1] > tr.t1)]
        return 1e3 * sum(durs) / len(durs) if durs else None

    def roofline(self, pattern, key: str, bound) -> float | None:
        """100 x (sum of ``bound(args, kwargs)`` over the recorded calls to
        ``key``) / (sum of the device times of the events ``pattern``
        matches), over the profiled steps; None if either is missing or
        the launches and the calls do not pair one to one."""
        tr = self.profile
        if tr is None:
            return None
        calls = tr.calls.get(key) or []
        events = tr.kernels(pattern)
        if not calls or not events:
            return None
        if len(calls) != len(events):
            self.notes.append(f"{key}: {len(calls)} calls but {len(events)} launches "
                              f"named {pattern.pattern}")
            return None
        device_s = sum(b - a for _, a, b in events) * 1e-9
        return 100.0 * sum(bound(a, kw) for a, kw in calls) / device_s
