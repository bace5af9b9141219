"""Counter / gauge / histogram registry with labeled series (stdlib only),
the port's copy of ``repro.obs.metrics``.

The global :data:`METRICS` registry is off by default: hot-path call sites
guard with ``if METRICS.enabled:``, so a disabled registry costs one
attribute read per chunk. ``METRICS.collecting()`` turns it on for a block
(``repro_torch.obs.observe()`` does this), after which the engine and the
learners record the reference's series, under the same names and labels:

* ``engine.chunk_seconds`` histogram, labels ``phase={synth,views,eval}``
  and ``backend`` (the evaluation device): per-chunk latency split;
* ``engine.scenarios_per_sec`` gauge, label ``backend``: streaming
  throughput of the last ``evaluate_grid`` call;
* ``scenarios.adaptive_escalations`` counter, label ``to=stage``: one
  increment per adaptive-adversary stage transition (periods -> phases ->
  locked), and ``scenarios.adaptive_chunks``, label ``stage``, one per
  chunk served;
* ``learn.weight_entropy`` histogram and ``learn.top_weight`` gauge, label
  ``learner``: Shannon entropy (nats) of a learner's mean weight posterior
  per streamed chunk, and the heaviest expert's share;
* ``engine.plan_cache`` counter, label ``event={hit,miss,evict}``: the
  cross-call plan cache, one hit or miss per group looked up, one evict per
  LRU ejection; ``engine.view_cache`` counts the view cache's evictions;
* ``engine.delta_groups_rescored`` counter: groups re-scored by
  ``evaluate_grid_delta``.

Snapshots (:meth:`MetricsRegistry.snapshot`) are plain JSON-able dicts,
attached to ``EngineResult.obs`` / ``StreamLearnResult.obs``.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

__all__ = ["METRICS", "Counter", "Gauge", "Histogram", "MetricsRegistry"]

# Geometric bucket upper bounds shared by every histogram: wide enough for
# seconds (1e-5 .. 1e3) and for unitless values like entropies.
_BUCKETS = tuple(10.0 ** (e / 2.0) for e in range(-10, 7))  # 1e-5 .. ~3.2e3


def _label_key(labels):
    return tuple(sorted(labels.items()))


class _Metric:
    kind = "metric"

    def __init__(self, name, registry):
        self.name = name
        self._registry = registry
        self._series = {}

    def _snapshot_series(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def snapshot(self):
        return {
            "kind": self.kind,
            "series": [
                {"labels": dict(k), **self._snapshot_value(v)}
                for k, v in sorted(self._series.items())
            ],
        }


class Counter(_Metric):
    kind = "counter"

    def inc(self, value=1.0, **labels):
        if not self._registry.enabled:
            return
        key = _label_key(labels)
        with self._registry._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels):
        return self._series.get(_label_key(labels), 0.0)

    def _snapshot_value(self, v):
        return {"value": v}


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value, **labels):
        if not self._registry.enabled:
            return
        with self._registry._lock:
            self._series[_label_key(labels)] = float(value)

    def value(self, **labels):
        return self._series.get(_label_key(labels))

    def _snapshot_value(self, v):
        return {"value": v}


class _Hist:
    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets = [0] * (len(_BUCKETS) + 1)

    def observe(self, v):
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        for i, le in enumerate(_BUCKETS):
            if v <= le:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1


class Histogram(_Metric):
    kind = "histogram"

    def observe(self, value, **labels):
        if not self._registry.enabled:
            return
        key = _label_key(labels)
        with self._registry._lock:
            h = self._series.get(key)
            if h is None:
                h = self._series[key] = _Hist()
            h.observe(float(value))

    def stats(self, **labels):
        h = self._series.get(_label_key(labels))
        return None if h is None else self._snapshot_value(h)

    def _snapshot_value(self, h):
        return {
            "count": h.count,
            "sum": h.sum,
            "mean": (h.sum / h.count) if h.count else 0.0,
            "min": None if h.count == 0 else h.min,
            "max": None if h.count == 0 else h.max,
            "buckets": [
                {"le": le, "count": c}
                for le, c in zip(list(_BUCKETS) + [math.inf], h.buckets)
                if c
            ],
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Name -> metric, get-or-create, with a global enable switch."""

    def __init__(self):
        self.enabled = False
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, name, kind):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = _KINDS[kind](name, self)
        if m.kind != kind:
            raise TypeError(f"metric {name!r} is a {m.kind}, not a {kind}")
        return m

    def counter(self, name) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name) -> Histogram:
        return self._get(name, "histogram")

    def snapshot(self):
        """JSON-able {name: {kind, series: [...]}} for all non-empty metrics."""
        return {
            name: m.snapshot()
            for name, m in sorted(self._metrics.items())
            if m._series
        }

    def reset(self):
        with self._lock:
            self._metrics.clear()

    @contextmanager
    def collecting(self, reset=False):
        """Enable recording for the block (restores the prior state)."""
        if reset:
            self.reset()
        prev = self.enabled
        self.enabled = True
        try:
            yield self
        finally:
            self.enabled = prev


METRICS = MetricsRegistry()
