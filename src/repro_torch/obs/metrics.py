"""Process-wide metrics registry: named counters, gauges, histograms.

The port's own copy of ``repro.obs.metrics`` (the port imports nothing
of the JAX package).  The serve engine's ``serve_stats()`` is a view
over this registry, so ``reset()`` here zeroes it along with every
other metric.

Stdlib-only: no NumPy or torch import here.

>>> from repro_torch.obs import metrics
>>> c = metrics.counter("serve.example")
>>> c.inc(3)
>>> metrics.snapshot(prefix="serve.example")["serve.example"]
3
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "delta",
    "reset",
    "on_reset",
]


class Counter:
    """Monotonic integer counter (until ``reset``)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Last-write-wins float value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Streaming summary (count/sum/min/max) plus a bounded sample
    reservoir for percentiles.  The reservoir keeps the most recent
    ``max_samples`` observations — latency series in this codebase are
    short (one entry per engine step), so "recent window" percentiles
    are exactly what the serve stats always reported."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples",
                 "max_samples", "_lock")

    def __init__(self, name: str, max_samples: int = 8192) -> None:
        self.name = name
        self.max_samples = max_samples
        self._lock = threading.Lock()
        self._zero()

    def _zero(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._samples: list[float] = []

    def observe(self, x: float) -> None:
        x = float(x)
        with self._lock:
            self.count += 1
            self.total += x
            if x < self.min:
                self.min = x
            if x > self.max:
                self.max = x
            if len(self._samples) >= self.max_samples:
                del self._samples[: self.max_samples // 2]
            self._samples.append(x)

    def reset(self) -> None:
        with self._lock:
            self._zero()

    def samples(self) -> list[float]:
        with self._lock:
            return list(self._samples)

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile over the reservoir (q in [0,100])."""
        with self._lock:
            xs = sorted(self._samples)
        if not xs:
            raise ValueError(f"histogram {self.name!r} is empty")
        if len(xs) == 1:
            return xs[0]
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> dict[str, float]:
        with self._lock:
            if not self.count:
                return {"count": 0}
            return {
                "count": self.count,
                "sum": self.total,
                "mean": self.total / self.count,
                "min": self.min,
                "max": self.max,
            }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Histogram({self.name}, n={self.count})"


class Registry:
    """Get-or-create store of named metrics.

    ``reset()`` zeroes every metric and then fires registered reset
    hooks (held by weakref so registering an engine does not leak it) —
    this is how one call also clears per-instance state like the serve
    scheduler's admission counters.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._hooks: list[weakref.WeakMethod | weakref.ref] = []

    def _get(self, name: str, cls: type) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self, prefix: str | None = None) -> dict[str, Any]:
        """Point-in-time values: counters -> int, gauges -> float,
        histograms -> summary dict."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict[str, Any] = {}
        for name, m in items:
            if prefix is not None and not name.startswith(prefix):
                continue
            if isinstance(m, Histogram):
                out[name] = m.summary()
            else:
                out[name] = m.value
        return out

    def delta(self, prev: dict[str, Any],
              prefix: str | None = None) -> dict[str, Any]:
        """Snapshot minus ``prev`` for numeric metrics; histogram
        summaries are passed through as-is (deltas of percentiles are
        not meaningful)."""
        cur = self.snapshot(prefix=prefix)
        out: dict[str, Any] = {}
        for name, v in cur.items():
            p = prev.get(name, 0)
            if isinstance(v, dict):
                out[name] = v
            else:
                out[name] = v - (p if isinstance(p, (int, float)) else 0)
        return out

    def on_reset(self, method: Callable[[], None]) -> None:
        """Register a bound method (weakly) to run after ``reset()``."""
        try:
            ref: weakref.WeakMethod | weakref.ref = weakref.WeakMethod(method)
        except TypeError:
            ref = weakref.ref(method)
        with self._lock:
            self._hooks.append(ref)

    def reset(self) -> None:
        with self._lock:
            metrics = list(self._metrics.values())
            hooks = list(self._hooks)
        for m in metrics:
            m.reset()
        for ref in hooks:
            cb = ref()
            if cb is not None:
                cb()
        with self._lock:
            self._hooks = [h for h in self._hooks if h() is not None]


REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
delta = REGISTRY.delta
reset = REGISTRY.reset
on_reset = REGISTRY.on_reset
