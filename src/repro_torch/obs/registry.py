"""Typed metrics: counters, gauges, histograms, rolling-window gauges.

``MetricsRegistry`` replaces the serving engine's raw ``counters``
dict with typed instruments while keeping the external schema
bit-compatible: :class:`CountersView` is a ``MutableMapping`` over the
registry's counters, so every pre-refactor call site
(``counters["ticks"] += 1``, ``dict(counters)``, iteration, equality,
reset-by-assignment) keeps working unchanged and
``metrics()["counters"]`` serializes to the identical plain dict.

Rolling-window gauges hold the last ``window`` ``(time, value)``
samples — the engine feeds one sample per tick (tok/s, queue depth,
batch occupancy, short-block rate), so their snapshots describe the
*recent* steady state rather than the whole run.

This module is also the canonical home of the percentile-block schema
every latency summary in the repo uses (``repro_torch.serving.metrics``
re-exports it)::

    {"p50": .., "p90": .., "p95": .., "p99": .., "mean": .., "max": ..}

i.e. one key per entry of ``PERCENTILES = (50, 90, 95, 99)`` plus
``mean`` and ``max``; an empty sample yields ``{}`` (never NaNs).
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

PERCENTILES = (50, 90, 95, 99)


def percentile_block(values: Sequence[float],
                     ps: Sequence[int] = PERCENTILES) -> Dict[str, float]:
    """The canonical summary block of a sample; ``{}`` when empty.
    ``None`` entries are dropped (unmeasured timestamps)."""
    xs = np.asarray([v for v in values if v is not None], float)
    if xs.size == 0:
        return {}
    out = {f"p{p}": float(np.percentile(xs, p)) for p in ps}
    out["mean"] = float(xs.mean())
    out["max"] = float(xs.max())
    return out


class Counter:
    """Monotonic-by-convention integer counter (resettable for bench
    warmup)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: int = 0):
        self.name = name
        self.value = value

    def inc(self, n: int = 1):
        self.value += n

    def set(self, value: int):
        self.value = value

    def __repr__(self):
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Last-value-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: float = 0.0):
        self.name = name
        self.value = value

    def set(self, value: float):
        self.value = value

    def __repr__(self):
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Bounded sample reservoir summarized as the canonical percentile
    block. Keeps the most recent ``max_samples`` observations — serving
    histograms describe recent behavior, not unbounded history."""

    __slots__ = ("name", "_samples")

    def __init__(self, name: str, max_samples: int = 4096):
        self.name = name
        self._samples: Deque[float] = collections.deque(maxlen=max_samples)

    def observe(self, value: float):
        self._samples.append(float(value))

    def __len__(self):
        return len(self._samples)

    def summary(self) -> Dict[str, float]:
        return percentile_block(self._samples)

    def __repr__(self):
        return f"Histogram({self.name}, n={len(self._samples)})"


class RollingGauge:
    """Sliding window of the last ``window`` ``(time, value)`` samples.

    ``snapshot()`` reports the last value, the window mean, the window
    rate (``sum(values) / (t_last - t_first)`` — meaningful when values
    are per-sample increments like tokens-per-tick; ``None`` until two
    samples span nonzero time), and the sample count.
    """

    __slots__ = ("name", "window", "_samples")

    def __init__(self, name: str, window: int = 64):
        self.name = name
        self.window = window
        self._samples: Deque[Tuple[float, float]] = \
            collections.deque(maxlen=window)

    def observe(self, t: float, value: float):
        self._samples.append((float(t), float(value)))

    def __len__(self):
        return len(self._samples)

    @property
    def last(self) -> Optional[float]:
        return self._samples[-1][1] if self._samples else None

    def mean(self) -> Optional[float]:
        if not self._samples:
            return None
        return float(np.mean([v for _, v in self._samples]))

    def rate(self) -> Optional[float]:
        if len(self._samples) < 2:
            return None
        span = self._samples[-1][0] - self._samples[0][0]
        if span <= 0:
            return None
        # the first sample's value predates the window's time span
        return float(sum(v for _, v in list(self._samples)[1:]) / span)

    def snapshot(self) -> Dict[str, Optional[float]]:
        return {"last": self.last, "mean": self.mean(),
                "rate": self.rate(), "n": len(self._samples)}

    def __repr__(self):
        return f"RollingGauge({self.name}, n={len(self._samples)})"


class CountersView(collections.abc.MutableMapping):
    """Dict-compatible facade over a registry's counters.

    Supports everything the pre-refactor raw dict was used for:
    ``view[k] += 1``, assignment (creates the counter on first write),
    iteration in creation order, ``dict(view)``, ``==`` against dicts
    and other views, and a dict-shaped ``repr``.
    """

    __slots__ = ("_registry",)

    def __init__(self, registry: "MetricsRegistry"):
        self._registry = registry

    def __getitem__(self, name: str) -> int:
        return self._registry._counters[name].value

    def __setitem__(self, name: str, value: int):
        self._registry.counter(name).set(value)

    def __delitem__(self, name: str):
        del self._registry._counters[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._registry._counters)

    def __len__(self) -> int:
        return len(self._registry._counters)

    def __eq__(self, other) -> bool:
        if isinstance(other, (dict, CountersView)):
            return dict(self) == dict(other)
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __repr__(self):
        return repr(dict(self))


class MetricsRegistry:
    """Named typed instruments; ``get-or-create`` accessors so call
    sites never race on registration order."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._rollings: Dict[str, RollingGauge] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, max_samples: int = 4096) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, max_samples)
        return h

    def rolling(self, name: str, window: int = 64) -> RollingGauge:
        r = self._rollings.get(name)
        if r is None:
            r = self._rollings[name] = RollingGauge(name, window)
        return r

    def counters_view(self) -> CountersView:
        return CountersView(self)

    def snapshot(self) -> Dict:
        """Everything, as plain JSON-ready dicts."""
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {k: h.summary()
                           for k, h in self._histograms.items()},
            "rolling": {k: r.snapshot()
                        for k, r in self._rollings.items()},
        }
