"""Mergeable process-wide metrics: counters, gauges, fixed-bucket histograms
(the port's copy of ``repro/obs/metrics.py``: pure Python, never reads a
tensor, and its snapshots merge with the JAX package's).

The registry is the fabric the whole stack reports into.  Every
instrument snapshots to plain wire-safe python (ints/floats/lists/str
keys only), so a worker can ship its snapshot inside a heartbeat pong
and the dispatcher can ``merge`` the per-process snapshots into one
fleet view.  Percentiles come from merged fixed-bucket histograms, not
from any single process's sample list — two processes that each saw
half the traffic merge to the same p50/p99 (within one bucket width)
as one process that saw all of it.

Merge semantics by instrument:

- counters: summed (they count events).
- histograms: per-bucket counts summed; ``sum``/``count`` summed.
  Bucket *bounds* must match — all parties use the same fixed layout,
  so merged percentiles are exact at bucket resolution.
- gauges: summed by default (occupancy/depth/bytes add across
  workers), except names whose last path segment ends in one of
  ``_MAX_GAUGE_SUFFIXES`` (ages, residuals, timestamps, condition
  estimates, verdicts) which take the max — "oldest request age" across
  a fleet is the max of the per-worker oldest ages, not their sum — and
  ``_MIN_GAUGE_SUFFIXES`` (breakdown margins) which take the min: the
  fleet's margin is its weakest member's.
"""

from __future__ import annotations

import threading
from typing import Iterable, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_buckets",
    "merge",
    "quantile",
    "registry",
]


def default_buckets() -> list[float]:
    """Geometric latency bounds: 1 us doubling up to ~67 s (27 buckets).

    One fixed layout everywhere keeps snapshots mergeable without
    negotiation; a factor-2 spacing bounds merged-percentile error at
    one octave, which is the resolution the bench gates need.
    """
    return [1e-6 * 2.0**i for i in range(27)]


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written level (occupancy, age, bytes)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram; bucket i counts samples <= bounds[i].

    Samples above the last bound land in a final overflow bucket, so
    ``counts`` has ``len(bounds) + 1`` entries and no sample is lost.
    """

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float] | None = None) -> None:
        self.bounds = list(bounds) if bounds is not None else default_buckets()
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # bisect keeps observe O(log buckets) on the hot path
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.sum += v
        self.count += 1


class MetricsRegistry:
    """Named instruments behind one lock; get-or-create by dotted name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(
        self, name: str, buckets: Sequence[float] | None = None
    ) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(buckets)
            return h

    def snapshot(self) -> dict:
        """Wire-safe copy of every instrument's current state."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {
                    k: {
                        "bounds": list(h.bounds),
                        "counts": list(h.counts),
                        "sum": h.sum,
                        "count": h.count,
                    }
                    for k, h in self._histograms.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# Gauge names whose last segment ends with one of these merge via max:
# ages/residuals/timestamps/condition-numbers/verdicts answer "worst
# anywhere", not "total".
_MAX_GAUGE_SUFFIXES = ("_age", "_age_s", "_residual", "_ts", "condest",
                       "verdict")

# ... and margins merge via min: the fleet's breakdown margin is the
# *smallest* per-worker margin, not the sum or the best.
_MIN_GAUGE_SUFFIXES = ("_margin",)


def _gauge_merges_max(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return leaf.endswith(_MAX_GAUGE_SUFFIXES)


def _gauge_merges_min(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return leaf.endswith(_MIN_GAUGE_SUFFIXES)


def merge(snapshots: Iterable[dict]) -> dict:
    """Fold per-process snapshots into one fleet view (see module doc)."""
    counters: dict[str, int] = {}
    gauges: dict[str, float] = {}
    histograms: dict[str, dict] = {}
    for snap in snapshots:
        if not snap:
            continue
        for k, v in snap.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in snap.get("gauges", {}).items():
            if k in gauges:
                if _gauge_merges_max(k):
                    gauges[k] = max(gauges[k], v)
                elif _gauge_merges_min(k):
                    gauges[k] = min(gauges[k], v)
                else:
                    gauges[k] = gauges[k] + v
            else:
                gauges[k] = v
        for k, h in snap.get("histograms", {}).items():
            cur = histograms.get(k)
            if cur is None:
                histograms[k] = {
                    "bounds": list(h["bounds"]),
                    "counts": list(h["counts"]),
                    "sum": h["sum"],
                    "count": h["count"],
                }
            else:
                if cur["bounds"] != list(h["bounds"]):
                    raise ValueError(
                        f"histogram {k!r}: bucket bounds differ across snapshots"
                    )
                cur["counts"] = [a + b for a, b in zip(cur["counts"], h["counts"])]
                cur["sum"] += h["sum"]
                cur["count"] += h["count"]
    return {"counters": counters, "gauges": gauges, "histograms": histograms}


def quantile(hist: dict, q: float) -> float:
    """q-quantile from a histogram snapshot (upper bound of its bucket).

    An empty histogram has no quantiles — returns ``nan`` (0.0 used to
    masquerade as a real observation). A quantile landing in the
    overflow bucket returns ``inf``: the histogram only knows the sample
    was above everything it can resolve, and reporting the top finite
    bound silently *understated* tail latency.
    """
    total = hist["count"]
    if total <= 0:
        return float("nan")
    rank = q * total
    acc = 0.0
    for i, c in enumerate(hist["counts"]):
        acc += c
        if acc >= rank and c > 0:
            if i >= len(hist["bounds"]):
                return float("inf")
            return hist["bounds"][i]
    return float("inf")


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """Process-wide default registry (what the serving stack reports to)."""
    return _default
