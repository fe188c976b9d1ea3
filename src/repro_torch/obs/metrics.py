# Copied from src/repro/obs/metrics.py (numpy and the standard library only); keep the two in step.
"""Thread-safe metrics primitives: counters, gauges, labeled
counters, array counters, and log-bucketed streaming histograms
(DESIGN.md §16).

Every primitive is independently lock-protected and O(1) per update,
so call sites can record from the flusher thread, the refresh thread,
and the exporter thread without coordinating.  The ``Histogram`` is
the load-bearing piece: geometric buckets (``growth`` ratio, default
5%) over a sparse dict give bounded memory no matter how many
observations stream through, while ``percentile()`` stays within one
bucket width of the exact nearest-rank answer — and ``min``/``max``
are tracked exactly, so the reported range is never an artifact of
bucketing.

The registry (``MetricsRegistry``) is a get-or-create namespace: a
call site asks for ``registry.counter("serve.tier.label.hits")`` and
shares the instance with every other site using that name.  Names are
dotted ``layer.component.metric`` paths (see DESIGN.md §16 for the
scheme); ``snapshot()`` renders everything JSON-safe and
``prometheus()`` renders the text exposition format.
"""
from __future__ import annotations

import math
import threading

import numpy as np


class Counter:
    """Monotonic (or at least add-only) scalar; ``inc`` accepts floats
    so the same primitive carries counts and accumulated seconds."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, amount: int | float = 1) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> int | float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar (queue depth, current epoch, ...)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: int | float) -> None:
        with self._lock:
            self._value = value

    @property
    def value(self) -> int | float:
        with self._lock:
            return self._value


class LabeledCounter:
    """Counter family keyed by one label value (flush reason, pow2
    occupancy bucket).  ``snapshot()`` returns ``{label: count}`` with
    string keys, sorted, which is exactly the perflog-record shape the
    batcher's ``occupancy_hist`` always had."""

    __slots__ = ("name", "_lock", "_counts")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counts: dict[str, int | float] = {}

    def inc(self, label, amount: int | float = 1) -> None:
        key = str(label)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + amount

    def get(self, label) -> int | float:
        with self._lock:
            return self._counts.get(str(label), 0)

    @property
    def total(self) -> int | float:
        with self._lock:
            return sum(self._counts.values())

    def snapshot(self) -> dict:
        with self._lock:
            return {k: self._counts[k] for k in sorted(self._counts)}


class ArrayCounter:
    """Fixed-size vector of int64 counters updated by bulk adds — the
    per-fragment traffic tallies the refresh pipeline prioritizes by.
    ``add`` takes a full-length count vector (np.bincount output);
    ``snapshot`` returns a copy."""

    __slots__ = ("name", "_lock", "_counts")

    def __init__(self, name: str, size: int):
        self.name = name
        self._lock = threading.Lock()
        self._counts = np.zeros(int(size), np.int64)

    def add(self, counts: np.ndarray) -> None:
        with self._lock:
            self._counts += counts

    def snapshot(self) -> np.ndarray:
        with self._lock:
            return self._counts.copy()

    @property
    def size(self) -> int:
        return len(self._counts)


class HistogramSnapshot:
    """Frozen view of a Histogram (or of the delta between two points
    in time): enough state to compute percentiles without holding the
    live histogram's lock."""

    __slots__ = ("counts", "count", "sum", "min", "max", "_lo",
                 "_log_growth")

    def __init__(self, counts, count, sum_, min_, max_, lo,
                 log_growth):
        self.counts = counts          # {bucket_idx: n}, sparse
        self.count = count
        self.sum = sum_
        self.min = min_               # exact; None when count == 0
        self.max = max_
        self._lo = lo
        self._log_growth = log_growth

    def _bucket_value(self, idx: int) -> float:
        # geometric midpoint of the bucket's (lo*g^(i-1), lo*g^i] span
        return self._lo * math.exp(self._log_growth * (idx - 0.5))

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (q in [0, 100]) to within one
        bucket width; clamped into the exact observed [min, max]."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen >= rank:
                v = self._bucket_value(idx)
                return min(max(v, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self, scale: float = 1.0, digits: int = 3) -> dict:
        """p50/p95/p99/mean/max (+count), each scaled (e.g. 1e3 for
        seconds -> ms) and rounded — the perflog-record shape."""
        return {
            "count": self.count,
            "p50": round(self.percentile(50) * scale, digits),
            "p95": round(self.percentile(95) * scale, digits),
            "p99": round(self.percentile(99) * scale, digits),
            "mean": round(self.mean * scale, digits),
            "max": round((self.max or 0.0) * scale, digits),
        }


class Histogram:
    """Log-bucketed streaming histogram: bounded memory, O(1) insert,
    percentile extraction within ``growth`` relative error.

    Bucket ``i`` covers ``(lo * growth**(i-1), lo * growth**i]``;
    observations at or below ``lo`` land in bucket 0, and the index is
    clamped to ``max_buckets`` so pathological outliers cannot grow
    the table without bound (their mass lands in the top bucket, and
    the exact tracked ``max`` still reports them truthfully).

    Defaults suit latencies in seconds: lo=1µs, growth=1.05 resolves
    5% relative error over 1µs..{growth**max_buckets·lo} ≈ 28 minutes.
    """

    __slots__ = ("name", "lo", "growth", "max_buckets", "_log_growth",
                 "_lock", "_counts", "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, *, lo: float = 1e-6,
                 growth: float = 1.05, max_buckets: int = 1536):
        if lo <= 0 or growth <= 1.0:
            raise ValueError(
                f"need lo > 0 and growth > 1: lo={lo} growth={growth}")
        self.name = name
        self.lo = lo
        self.growth = growth
        self.max_buckets = max_buckets
        self._log_growth = math.log(growth)
        self._lock = threading.Lock()
        self._counts: dict[int, int] = {}
        self._count = 0
        self._sum = 0.0
        self._min: float | None = None
        self._max: float | None = None

    def _bucket(self, x: float) -> int:
        if x <= self.lo:
            return 0
        idx = math.ceil(math.log(x / self.lo) / self._log_growth)
        return min(idx, self.max_buckets)

    def observe(self, x: float) -> None:
        x = float(x)
        idx = self._bucket(x)
        with self._lock:
            self._counts[idx] = self._counts.get(idx, 0) + 1
            self._count += 1
            self._sum += x
            if self._min is None or x < self._min:
                self._min = x
            if self._max is None or x > self._max:
                self._max = x

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def freeze(self) -> HistogramSnapshot:
        """Consistent point-in-time copy."""
        with self._lock:
            return HistogramSnapshot(
                dict(self._counts), self._count, self._sum,
                self._min, self._max, self.lo, self._log_growth)

    def since(self, prev: HistogramSnapshot) -> HistogramSnapshot:
        """Snapshot of everything observed AFTER ``prev`` was frozen —
        how the load harness scopes percentiles to one phase of a
        shared runtime.  Bucket counts and count/sum subtract exactly;
        min/max fall back to the window's bucket bounds when the
        all-time extremum predates the window (bounded by the same
        ``growth`` relative error as any percentile)."""
        cur = self.freeze()
        counts = {i: n - prev.counts.get(i, 0)
                  for i, n in cur.counts.items()
                  if n - prev.counts.get(i, 0) > 0}
        count = cur.count - prev.count
        if count <= 0:
            return HistogramSnapshot({}, 0, 0.0, None, None, self.lo,
                                     self._log_growth)
        lo_idx, hi_idx = min(counts), max(counts)
        mn = cur.min if prev.count == 0 or cur.min != prev.min else \
            self.lo * math.exp(self._log_growth * (lo_idx - 1))
        mx = cur.max if prev.count == 0 or cur.max != prev.max else \
            self.lo * math.exp(self._log_growth * hi_idx)
        return HistogramSnapshot(counts, count, cur.sum - prev.sum,
                                 mn, mx, self.lo, self._log_growth)

    def percentile(self, q: float) -> float:
        return self.freeze().percentile(q)

    def summary(self, scale: float = 1.0, digits: int = 3) -> dict:
        return self.freeze().summary(scale, digits)


def _prom_name(name: str) -> str:
    """Prometheus metric names allow [a-zA-Z0-9_:]; our dotted paths
    map ``.`` and ``-`` to ``_``."""
    return "".join(c if c.isalnum() or c in "_:" else "_"
                   for c in name)


class MetricsRegistry:
    """Get-or-create namespace of metrics, shared across a runtime.

    Type-stable by name: asking for ``counter(n)`` after ``gauge(n)``
    was registered raises — two call sites silently aliasing one name
    to different primitives is always a bug.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get_or_create(self, name: str, cls, *args, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def labeled(self, name: str) -> LabeledCounter:
        return self._get_or_create(name, LabeledCounter)

    def array_counter(self, name: str, size: int) -> ArrayCounter:
        return self._get_or_create(name, ArrayCounter, size)

    def histogram(self, name: str, **kwargs) -> Histogram:
        return self._get_or_create(name, Histogram, **kwargs)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> dict:
        """JSON-safe dump of every metric: scalars as-is, labeled
        counters as dicts, array counters as nonzero totals, and
        histograms as their p50/p95/p99/mean/max summaries."""
        with self._lock:
            items = sorted(self._metrics.items())
        out: dict[str, object] = {}
        for name, m in items:
            if isinstance(m, (Counter, Gauge)):
                out[name] = m.value
            elif isinstance(m, LabeledCounter):
                out[name] = m.snapshot()
            elif isinstance(m, ArrayCounter):
                c = m.snapshot()
                out[name] = {"size": int(c.size),
                             "total": int(c.sum()),
                             "nonzero": int((c > 0).sum()),
                             "max": int(c.max()) if c.size else 0}
            elif isinstance(m, Histogram):
                out[name] = m.summary()
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition (0.0.4): counters/gauges as
        bare samples, labeled counters with a ``label=...`` tag,
        histograms as summary quantiles + _count/_sum."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: list[str] = []
        for name, m in items:
            pn = _prom_name(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pn} counter")
                lines.append(f"{pn} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {m.value}")
            elif isinstance(m, LabeledCounter):
                lines.append(f"# TYPE {pn} counter")
                for label, v in m.snapshot().items():
                    lines.append(f'{pn}{{label="{label}"}} {v}')
            elif isinstance(m, ArrayCounter):
                c = m.snapshot()
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f'{pn}{{stat="total"}} {int(c.sum())}')
                lines.append(
                    f'{pn}{{stat="max"}} '
                    f'{int(c.max()) if c.size else 0}')
            elif isinstance(m, Histogram):
                snap = m.freeze()
                lines.append(f"# TYPE {pn} summary")
                for q in (0.5, 0.95, 0.99):
                    lines.append(
                        f'{pn}{{quantile="{q}"}} '
                        f'{snap.percentile(q * 100):.9g}')
                lines.append(f"{pn}_sum {snap.sum:.9g}")
                lines.append(f"{pn}_count {snap.count}")
        return "\n".join(lines) + "\n"
