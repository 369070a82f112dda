"""Label-aware metrics registry: Counter / Gauge / Histogram (a copy of
``paddle_tpu/observability/metrics.py``).

Design constraints: pure python, allocation-light,
default-on.  The hot path of every instrument is a dict lookup plus a
float add under a per-metric lock — no exporter, no thread, no socket
exists until one is explicitly attached (or requested via the
``PADDLE_TPU_METRICS_PORT`` / ``PADDLE_TPU_METRICS_JSONL`` env vars,
see :mod:`paddle_tpu_torch.observability.exposition`).

Naming conventions (see observability/README.md): every series is
``paddle_tpu_<subsystem>_<what>_<unit>``; counters end in ``_total``,
durations are ``_seconds``.  Label cardinality is capped per metric
(default 64 label-sets): past the cap, novel label-sets collapse into a
single ``other="true"`` overflow series instead of growing without
bound — telemetry must never OOM the process it watches.

Gauges may hold *lazy* values: ``set()`` accepts anything ``float()``
can digest at collection time, including a device scalar — the hot path
stores the reference and the device sync (if any) happens only when an
exporter scrapes.  Pull-style gauges (``set_function``) cost nothing
until collection.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "DEFAULT_BUCKETS"]

# Latency-oriented default bucket bounds (seconds), 1ms .. 60s.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_OVERFLOW = ("__overflow__",)


def _check_labels(labelnames: Sequence[str]):
    for n in labelnames:
        if not n or not n.replace("_", "a").isalnum() or n[0].isdigit():
            raise ValueError(f"invalid label name {n!r}")


class _Metric:
    """Shared parent plumbing: label-set -> child instance, cardinality
    cap, locked child table."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (), max_series: int = 64):
        _check_labels(labelnames)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            # the unlabeled metric IS its own single child
            self._children[()] = self

    def labels(self, *values, **kwargs):
        if kwargs:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            values = tuple(str(kwargs[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got "
                f"{values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                if len(self._children) >= self.max_series:
                    # cardinality cap: collapse the tail into one
                    # overflow series rather than growing unboundedly
                    values = _OVERFLOW * len(self.labelnames)
                    child = self._children.get(values)
                    if child is not None:
                        return child
                child = self._new_child()
                self._children[values] = child
            return child

    def _new_child(self):
        cls = type(self)
        obj = cls.__new__(cls)
        _Metric.__init__(obj, self.name, self.help, ())
        obj._init_state()
        return obj

    def _init_state(self):  # pragma: no cover - overridden
        pass

    def series(self) -> List[Tuple[Tuple[str, ...], "_Metric"]]:
        """Snapshot of (label_values, child) pairs."""
        with self._lock:
            if not self.labelnames:
                return [((), self._children[()])]
            return list(self._children.items())


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=(), max_series=64):
        super().__init__(name, help, labelnames, max_series)
        self._init_state()

    def _init_state(self):
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    def value(self) -> float:
        return self._value


class Gauge(_Metric):
    """Point-in-time value; may be set lazily (device scalar resolved at
    collection) or backed by a pull function."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=(), max_series=64):
        super().__init__(name, help, labelnames, max_series)
        self._init_state()

    def _init_state(self):
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value):
        self._value = value          # no float(): sync deferred to scrape

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value = self.value() + amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]):
        """Pull-style gauge: ``fn`` is called at collection time only —
        zero hot-path cost for values the owner already tracks (queue
        depth, slot occupancy)."""
        self._fn = fn

    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")  # a dead callback must not kill scrape
        try:
            return float(self._value)
        except Exception:
            return float("nan")


class Histogram(_Metric):
    """Fixed-bucket histogram with cumulative bucket counts plus
    p50/p90/p99 estimated by linear interpolation within the bucket that
    crosses the target rank (standard Prometheus-side math, done here so
    ``summary()`` tables can show quantiles without a scrape)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 max_series=64):
        self._bounds = tuple(sorted(float(b) for b in buckets))
        if not self._bounds:
            raise ValueError("need at least one bucket bound")
        super().__init__(name, help, labelnames, max_series)
        self._init_state()

    def _new_child(self):
        obj = Histogram.__new__(Histogram)
        obj._bounds = self._bounds
        _Metric.__init__(obj, self.name, self.help, ())
        obj._init_state()
        return obj

    def _init_state(self):
        self._counts = [0] * (len(self._bounds) + 1)   # +inf tail
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, value: float):
        value = float(value)
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def bounds(self) -> Tuple[float, ...]:
        return self._bounds

    def count(self) -> int:
        return self._count

    def sum(self) -> float:
        return self._sum

    def cumulative_counts(self) -> List[int]:
        """Per-bucket cumulative counts aligned with ``bounds`` + +inf."""
        out, acc = [], 0
        with self._lock:
            for c in self._counts:
                acc += c
                out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile from bucket counts (observed min/max
        clamp the first/last bucket so estimates can't leave the data's
        range).  NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            total = self._count
            if total == 0:
                return float("nan")
            target = q * total
            acc = 0.0
            lo = self._min
            for i, c in enumerate(self._counts):
                hi = self._bounds[i] if i < len(self._bounds) else self._max
                hi = min(hi, self._max)
                if c and acc + c >= target:
                    frac = (target - acc) / c
                    return lo + (hi - lo) * max(0.0, min(1.0, frac))
                if c:
                    lo = hi
                acc += c
            return self._max

    def summary(self) -> Dict[str, float]:
        return {"count": float(self._count), "sum": self._sum,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Name -> metric table.  Constructors are get-or-create so every
    instrumented module can say ``REG.counter("x_total", ...)`` at call
    time without coordinating module import order; re-registering an
    existing name with a different type or label schema raises."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or (
                        m.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}")
                return m
            m = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = (), **kw) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames, **kw)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (), **kw) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames, **kw)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **kw) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets, **kw)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def unregister(self, name: str):
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self):
        with self._lock:
            self._metrics.clear()

    def collect(self) -> List[dict]:
        """Uniform snapshot used by every exporter:
        [{name, kind, help, series: [{labels, value | histogram}]}]."""
        out = []
        for m in self.metrics():
            series = []
            for values, child in m.series():
                labels = dict(zip(m.labelnames, values))
                if isinstance(child, Histogram):
                    # min/max ride along so a cross-process merge
                    # (observability.fleet) can reconstruct a histogram
                    # whose quantile clamps stay data-bounded
                    series.append({
                        "labels": labels,
                        "buckets": list(zip(child.bounds,
                                            child.cumulative_counts())),
                        "count": child.count(), "sum": child.sum(),
                        "min": child._min, "max": child._max,
                        "summary": child.summary()})
                else:
                    series.append({"labels": labels,
                                   "value": child.value()})
            out.append({"name": m.name, "kind": m.kind, "help": m.help,
                        "series": series})
        return out


_DEFAULT = MetricsRegistry()
_ENV_CHECKED = False


def default_registry() -> MetricsRegistry:
    """The process-wide registry every built-in instrument writes to.
    First use checks the exposition env vars (PADDLE_TPU_METRICS_PORT /
    PADDLE_TPU_METRICS_JSONL) and attaches the requested exporters."""
    global _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        from paddle_tpu_torch.observability import exposition
        exposition.maybe_start_from_env(_DEFAULT)
    return _DEFAULT
