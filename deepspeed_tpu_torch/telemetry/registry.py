"""Process-local metrics registry (the port's copy of
``deepspeed_tpu/telemetry/registry.py``, pure Python, unchanged).

The single sink for every counter the framework emits: serving metrics
(queue depth, prefill/decode latency histograms, prefix-cache and KV-tier
counters), the recompile sentinel, the memory ledger and the step
timeline all register here and flow out through
``telemetry/exporter.py`` (Prometheus text / JSONL).

Three metric types, deliberately the Prometheus trio:

* ``Counter`` — monotonically increasing total (``_total`` suffix by
  convention).
* ``Gauge``  — point-in-time value.
* ``Histogram`` — fixed-bucket distribution with ``quantile()``
  (p50/p95/p99) computed by linear interpolation inside the owning
  bucket, the same estimate PromQL's ``histogram_quantile`` makes.

Metric names are validated at registration: ``snake_case`` with the
``deepspeed_tpu_`` namespace prefix (the JAX package's
``tools/check_metric_names.py`` enforces the same rule statically).  Registration is
get-or-create: re-registering the same name with the same type returns
the existing metric (engines are constructed many times per process);
re-registering with a DIFFERENT type raises.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

METRIC_NAME_RE = re.compile(r"^deepspeed_tpu_[a-z][a-z0-9_]*$")

#: default latency buckets (seconds): sub-ms dispatch up to minute-long
#: stalls, roughly log-spaced like prometheus_client's defaults
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]) -> LabelKey:
    if set(labels) != set(labelnames):
        raise ValueError(f"expected labels {tuple(labelnames)}, got "
                         f"{tuple(labels)}")
    return tuple((k, str(labels[k])) for k in labelnames)


class Metric:
    """Base: a named family of (label-set -> series)."""

    type: str = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not METRIC_NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must be snake_case and start with "
                "the 'deepspeed_tpu_' namespace prefix")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> LabelKey:
        return _label_key(self.labelnames, labels)

    def series(self) -> Iterable[Tuple[LabelKey, object]]:
        raise NotImplementedError

    def samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        """Flat ``(sample_name, labels, value)`` rows for exporters."""
        raise NotImplementedError


class Counter(Metric):
    type = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def series(self):
        # lock: the HTTP exporter iterates from its own thread while the
        # training thread may be inserting a first-seen label set
        with self._lock:
            return list(self._values.items())

    def samples(self):
        out = [(self.name, dict(k), v) for k, v in self.series()]
        return out or ([(self.name, {}, 0.0)] if not self.labelnames else [])


class Gauge(Metric):
    type = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def series(self):
        with self._lock:
            return list(self._values.items())

    def samples(self):
        return [(self.name, dict(k), v) for k, v in self.series()]


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 for the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(Metric):
    """Fixed-bucket histogram with Prometheus-style quantile estimation."""

    type = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        b = sorted(float(x) for x in buckets)
        if not b or any(not math.isfinite(x) for x in b):
            raise ValueError("buckets must be finite and non-empty")
        self.buckets = tuple(b)
        self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = _HistSeries(len(self.buckets))
            s.counts[bisect.bisect_left(self.buckets, value)] += 1
            s.sum += value
            s.count += 1

    def count(self, **labels) -> int:
        s = self._series.get(self._key(labels))
        return s.count if s else 0

    def sum(self, **labels) -> float:
        s = self._series.get(self._key(labels))
        return s.sum if s else 0.0

    def quantile(self, q: float, **labels) -> float:
        """Estimate the q-quantile (q in [0,1]) by linear interpolation
        inside the owning bucket — the ``histogram_quantile`` estimate.
        Values in the +Inf bucket clamp to the highest finite bound."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0,1], got {q}")
        s = self._series.get(self._key(labels))
        if s is None or s.count == 0:
            return float("nan")
        rank = q * s.count
        cum = 0.0
        for i, c in enumerate(s.counts):
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self.buckets):  # +Inf bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * frac
        return self.buckets[-1]

    def percentiles(self, **labels) -> Dict[str, float]:
        return {p: self.quantile(v, **labels)
                for p, v in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))}

    def series(self):
        with self._lock:
            return list(self._series.items())

    def samples(self):
        out = []
        for k, s in self.series():
            base = dict(k)
            cum = 0
            for i, bound in enumerate(self.buckets):
                cum += s.counts[i]
                out.append((self.name + "_bucket",
                            dict(base, le=_fmt_float(bound)), float(cum)))
            out.append((self.name + "_bucket", dict(base, le="+Inf"),
                        float(s.count)))
            out.append((self.name + "_sum", base, s.sum))
            out.append((self.name + "_count", dict(base), float(s.count)))
        return out


def _fmt_float(v: float) -> str:
    if v == int(v):
        return str(int(v)) + ".0"
    return repr(v)


class MetricsRegistry:
    """Named collection of metrics with get-or-create registration."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name, help, labelnames, **kw) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.type}, cannot re-register as "
                        f"{cls.type}")
                if tuple(labelnames) != existing.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{existing.labelnames}, got {tuple(labelnames)}")
                return existing
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def collect(self) -> List[Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------- fan-out
    def snapshot_events(self, step: int) -> List[Tuple[str, float, int]]:
        """Flatten to ``(tag, value, step)`` events for monitor writers.
        Histograms surface as p50/p95/p99/count/sum sub-tags; labeled
        series embed their labels in the tag path."""
        events: List[Tuple[str, float, int]] = []
        for m in self.collect():
            if isinstance(m, Histogram):
                for k, s in m.series():
                    tag = _event_tag(m.name, dict(k))
                    if s.count == 0:
                        continue
                    for p, v in m.percentiles(**dict(k)).items():
                        events.append((f"{tag}/{p}", float(v), step))
                    events.append((f"{tag}/count", float(s.count), step))
                    events.append((f"{tag}/sum", float(s.sum), step))
            else:
                for k, v in m.series():
                    events.append((_event_tag(m.name, dict(k)), float(v),
                                   step))
        return events


def _event_tag(name: str, labels: Dict[str, str]) -> str:
    tag = name
    for k in sorted(labels):
        tag += f"/{k}={labels[k]}"
    return tag


_default_registry: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-local default registry (created on first use)."""
    global _default_registry
    if _default_registry is None:
        with _default_lock:
            if _default_registry is None:
                _default_registry = MetricsRegistry()
    return _default_registry


def set_registry(registry: Optional[MetricsRegistry]) -> None:
    """Swap the process default (tests install a fresh one)."""
    global _default_registry
    with _default_lock:
        _default_registry = registry
