"""Zero-dependency metrics core for the serving engine (port of
``repro/serving/metrics.py``; host-side Python only, same bucket bounds and
percentile rule, so the port's histograms equal the reference's on the same
observations).

Three instrument kinds — :class:`Counter`, :class:`Gauge`,
:class:`Histogram` — each supporting label sets (``inc(site="page_alloc")``)
with a stable, sorted series keying so snapshots are deterministic and
diffable.  Histograms use **fixed-memory log-spaced buckets**: the bucket
bounds are decided at construction (``lo * 10^(i/per_decade)``), every
observation is one integer increment, and percentiles are extracted by an
exact, documented rule (below) — no sample retention, no reservoir, O(1)
memory per label set no matter how many observations land.

A :class:`MetricsRegistry` owns the instruments and an **injectable
monotonic clock** (default ``time.perf_counter``): the engine routes every
timestamp through ``registry.now()``, so tests swap in a fake clock and get
bit-stable latency histograms, timelines, and trace exports.

Percentile rule (deterministic, documented so tests can hand-compute):
for quantile ``q`` over ``count`` observations, take
``rank = ceil(q * count)`` clamped to ``[1, count]``, walk the cumulative
bucket counts to the first bucket whose cumulative count reaches ``rank``,
and report that bucket's **upper bound**, clamped into the observed
``[min, max]``.  Consequences worth knowing:

- a histogram holding one distinct value reports that exact value at every
  quantile (the clamp to ``[min, max]`` collapses the bucket bound);
- the reported quantile is never below an observation that should be under
  it (upper bound ⇒ conservative), and the relative error is bounded by the
  bucket ratio ``10^(1/per_decade)`` (~21% per bucket at the default 12
  buckets/decade — tighten ``per_decade`` to trade memory for resolution);
- overflow observations (``> bounds[-1]``) report the observed max.

:class:`HistSnap` (from ``Histogram.counts()``) supports subtraction, so a
benchmark can diff two snapshots and compute percentiles **of just the
observations in between**: per-wave TTFT/ITL from a warm engine without
resetting it.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "HistSnap", "MetricsRegistry",
    "percentile_from_counts", "format_pending",
]

#: canonical label-set key: sorted (k, v) pairs, values stringified
LabelKey = Tuple[Tuple[str, str], ...]


def _key(labels: dict) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_key(key: LabelKey) -> str:
    """``""`` for the unlabeled series, else ``"k1=v1,k2=v2"`` (sorted)."""
    return ",".join(f"{k}={v}" for k, v in key)


class Counter:
    """Monotonic labeled counter.  ``inc(n, **labels)``; never decreases."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        k = _key(labels)
        self._series[k] = self._series.get(k, 0) + n

    def value(self, **labels) -> float:
        return self._series.get(_key(labels), 0)

    def total(self) -> float:
        return sum(self._series.values())

    def snapshot(self) -> Dict[str, float]:
        return {_fmt_key(k): v for k, v in sorted(self._series.items())}


class Gauge:
    """Labeled point-in-time value.  ``set(v, **labels)``."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[LabelKey, float] = {}

    def set(self, v: float, **labels) -> None:
        self._series[_key(labels)] = v

    def value(self, **labels) -> float:
        return self._series.get(_key(labels), 0)

    def snapshot(self) -> Dict[str, float]:
        return {_fmt_key(k): v for k, v in sorted(self._series.items())}


@dataclasses.dataclass(frozen=True)
class HistSnap:
    """Immutable copy of one histogram series' bucket state.  Subtraction
    yields the observations recorded *between* the two snapshots (bucket
    counts, count and sum diff exactly; min/max are not invertible, so a
    delta carries ``None`` there and percentiles fall back to raw bucket
    bounds — fine for the benchmark use, where the bucket-ratio error bound
    still holds)."""
    bounds: Tuple[float, ...]
    buckets: Tuple[int, ...]        # len(bounds) + 1 (last = overflow)
    count: int
    sum: float
    vmin: Optional[float]
    vmax: Optional[float]

    def __sub__(self, other: "HistSnap") -> "HistSnap":
        if self.bounds != other.bounds:
            raise ValueError("histogram snapshots with different bounds")
        return HistSnap(
            bounds=self.bounds,
            buckets=tuple(a - b for a, b in
                          zip(self.buckets, other.buckets)),
            count=self.count - other.count,
            sum=self.sum - other.sum,
            vmin=None, vmax=None)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        return percentile_from_counts(
            self.bounds, self.buckets, q, vmin=self.vmin, vmax=self.vmax)


def percentile_from_counts(bounds, buckets, q, *, vmin=None, vmax=None):
    """The documented percentile rule over raw bucket counts."""
    count = sum(buckets)
    if count <= 0:
        return 0.0
    rank = min(max(math.ceil(q * count), 1), count)
    cum = 0
    val = None
    for i, c in enumerate(buckets):
        cum += c
        if cum >= rank:
            val = bounds[i] if i < len(bounds) else (
                vmax if vmax is not None else bounds[-1])
            break
    if vmin is not None:
        val = max(val, vmin)
    if vmax is not None:
        val = min(val, vmax)
    return val


class Histogram:
    """Labeled log-spaced histogram with fixed memory per series.

    Buckets: ``value <= bounds[i]`` lands in bucket ``i`` (first bucket
    catches everything ``<= lo``, including zeros/negatives); one overflow
    bucket catches ``value > bounds[-1]``.  Default range 1µs..1000s at 12
    buckets/decade = 109 bounds — sized for latencies in seconds.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *,
                 lo: float = 1e-6, hi: float = 1e3, per_decade: int = 12):
        if not (0 < lo < hi):
            raise ValueError(f"histogram {name}: need 0 < lo < hi")
        self.name = name
        self.help = help
        n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
        self.bounds: Tuple[float, ...] = tuple(
            lo * 10 ** (i / per_decade) for i in range(n))
        self._series: Dict[LabelKey, List[int]] = {}
        self._count: Dict[LabelKey, int] = {}
        self._sum: Dict[LabelKey, float] = {}
        self._min: Dict[LabelKey, float] = {}
        self._max: Dict[LabelKey, float] = {}

    def _bucket(self, v: float) -> int:
        """Index of the first bound >= v (overflow = len(bounds)).  Binary
        search over the precomputed bounds — no float-log roundtrip, so the
        bucket edge is exact."""
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.bounds[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, v: float, **labels) -> None:
        k = _key(labels)
        b = self._series.get(k)
        if b is None:
            b = self._series[k] = [0] * (len(self.bounds) + 1)
            self._count[k] = 0
            self._sum[k] = 0.0
            self._min[k] = v
            self._max[k] = v
        b[self._bucket(v)] += 1
        self._count[k] += 1
        self._sum[k] += v
        self._min[k] = min(self._min[k], v)
        self._max[k] = max(self._max[k], v)

    def counts(self, **labels) -> HistSnap:
        k = _key(labels)
        if k not in self._series:
            return HistSnap(self.bounds, (0,) * (len(self.bounds) + 1),
                            0, 0.0, None, None)
        return HistSnap(self.bounds, tuple(self._series[k]),
                        self._count[k], self._sum[k],
                        self._min[k], self._max[k])

    def percentile(self, q: float, **labels) -> float:
        return self.counts(**labels).percentile(q)

    def summary(self, **labels) -> Dict[str, float]:
        """The stat block snapshots and report lines use: count, sum, mean, min,
        max, p50/p90/p99 — all under the documented percentile rule."""
        s = self.counts(**labels)
        return {
            "count": s.count,
            "sum": s.sum,
            "mean": s.mean,
            "min": s.vmin if s.vmin is not None else 0.0,
            "max": s.vmax if s.vmax is not None else 0.0,
            "p50": s.percentile(0.50),
            "p90": s.percentile(0.90),
            "p99": s.percentile(0.99),
        }

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {_fmt_key(k): self.summary(**dict(k))
                for k in sorted(self._series)}


class MetricsRegistry:
    """Instrument factory + snapshot root.  ``clock`` is the single time
    source for everything observability touches — the engine binds its own
    (test-swappable) ``_clock`` here, so faking the engine clock fakes every
    histogram, timeline, and trace timestamp with it."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._metrics: Dict[str, object] = {}

    def now(self) -> float:
        return self.clock()

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", *,
                  lo: float = 1e-6, hi: float = 1e3,
                  per_decade: int = 12) -> Histogram:
        return self._get(Histogram, name, help,
                         lo=lo, hi=hi, per_decade=per_decade)

    def snapshot(self) -> Dict[str, Dict]:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}``,
        every level sorted by name/labels — byte-stable under a fixed
        clock."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[m.kind + "s"][name] = m.snapshot()
        return out


# --------------------------------------------------------------- report ---
def format_pending(snap: dict) -> str:
    """Render ``metrics_snapshot()["pending"]`` + pager occupancy as the
    stall/max_steps diagnostic text (``ServingEngine._pending_report``)."""
    lines = []
    for p in snap["pending"]:
        d = p["deadline_left_s"]
        dtxt = f"{d:.3f}s" if d is not None else "-"
        slot = f"slot={p['slot']} pos={p['pos']} " if p["slot"] is not None \
            else ""
        lines.append(
            f"  uid={p['uid']} phase={p['phase']} "
            + (f"prompt={p['prompt']} " if p["slot"] is None else slot)
            + f"out={p['out']}/{p['max_tokens']} retries={p['retries']} "
            f"deadline={dtxt}")
    pg = snap["pager"]
    lines.append(
        f"  pager: free={pg['free_pages']}/{pg['total_pages']} "
        f"held={pg['held']} evictable={pg['evictable']} "
        f"swapped_images={pg['swapped_images']}")
    return "\n".join(lines)
