"""Streaming fixed-bucket histograms for latency and size distributions.

A t-digest would give tighter tail quantiles, but fixed log-spaced buckets
are O(1) per observation, mergeable, thread-safe under one short lock, and
map 1:1 onto Prometheus histogram exposition (cumulative ``le`` buckets) —
the export format this subsystem targets. Quantiles are interpolated within
the bucket, so the error is bounded by bucket width (~2.15x per step on the
default 1-2.15-4.6 decade grid).
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import List, Optional, Sequence

__all__ = ["StreamingHistogram", "LATENCY_BOUNDS_S", "SIZE_BOUNDS"]


def _log_bounds(lo_exp: int, hi_exp: int, per_decade: int = 3) -> List[float]:
    out = []
    for e in range(lo_exp, hi_exp + 1):
        for i in range(per_decade):
            out.append(round(10.0 ** (e + i / per_decade), 12))
    return out


#: 1 µs .. 100 s, 3 buckets per decade — covers everything from a no-op span
#: to a wedged multi-second IO.
LATENCY_BOUNDS_S: List[float] = _log_bounds(-6, 2)

#: 1 B .. 10 GB, 3 buckets per decade — batch/payload byte distributions.
SIZE_BOUNDS: List[float] = _log_bounds(0, 10)


class StreamingHistogram:
    """Thread-safe fixed-bucket histogram with count/sum/min/max.

    :param bounds: ascending upper bucket bounds; an implicit +Inf bucket
        catches the overflow. Defaults to :data:`LATENCY_BOUNDS_S`.
    """

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        b = list(bounds) if bounds is not None else list(LATENCY_BOUNDS_S)
        if not b or sorted(b) != b:
            raise ValueError("bounds must be a non-empty ascending sequence")
        self._bounds = b
        self._counts = [0] * (len(b) + 1)  # +1: the +Inf overflow bucket
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect_left(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    # ------------------------------------------------------------ readout
    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _state(self):
        """One consistent copy of the mutable state, under one lock hold."""
        with self._lock:
            return list(self._counts), self._count, self._sum, self._min, \
                self._max

    def _interp_quantile(self, counts, count, mn, mx, q: float) -> float:
        if count == 0:
            return 0.0
        target = q * count
        seen = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = self._bounds[i - 1] if i > 0 else min(
                    mn, self._bounds[0])
                hi = (self._bounds[i] if i < len(self._bounds)
                      else max(mx, self._bounds[-1]))
                lo = max(lo, mn)
                hi = min(hi, mx) if mx >= lo else hi
                frac = (target - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return mx

    @staticmethod
    def _cumulative(bounds, counts) -> List[List[float]]:
        out = []
        cum = 0
        for bound, c in zip(bounds, counts):
            cum += c
            out.append([bound, cum])
        out.append([None, cum + counts[-1]])
        return out

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0..1), interpolated inside the bucket."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        counts, count, _total, mn, mx = self._state()
        return self._interp_quantile(counts, count, mn, mx, q)

    def buckets(self) -> List[List[float]]:
        """Cumulative ``[upper_bound, count]`` pairs (Prometheus ``le``
        semantics); the final bound is +Inf rendered as ``None``."""
        counts, _count, _total, _mn, _mx = self._state()
        return self._cumulative(self._bounds, counts)

    def merge(self, other: "StreamingHistogram") -> None:
        if other._bounds != self._bounds:
            raise ValueError("cannot merge histograms with different bounds")
        with other._lock:
            counts = list(other._counts)
            count, total = other._count, other._sum
            mn, mx = other._min, other._max
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._count += count
            self._sum += total
            self._min = min(self._min, mn)
            self._max = max(self._max, mx)

    def _summary(self, counts, count, total, mn, mx) -> dict:
        """Render one captured state as the JSON-safe summary dict — the
        single source of truth for both :meth:`as_dict` and :meth:`drain`."""
        def q(p):
            return round(self._interp_quantile(counts, count, mn, mx, p), 9)

        return {"count": count, "sum": round(total, 6),
                "min": round(mn if count else 0.0, 9),
                "max": round(mx if count else 0.0, 9),
                "p50": q(0.50), "p95": q(0.95), "p99": q(0.99),
                "buckets": self._cumulative(self._bounds, counts)}

    def as_dict(self) -> dict:
        """JSON-safe summary. Count, sum, quantiles, and buckets all derive
        from ONE locked copy of the state, so a snapshot taken while other
        threads observe() is internally consistent (count always equals the
        +Inf bucket, quantiles never reflect newer samples than count)."""
        return self._summary(*self._state())

    def drain(self) -> dict:
        """Atomically capture :meth:`as_dict` and zero the histogram under
        ONE lock hold — an observation lands either in the returned summary
        or in the new epoch, never in neither (registry ``reset()`` uses
        this to return a lossless pre-reset snapshot)."""
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
            self._zero_locked()
        return self._summary(counts, count, total, mn, mx)

    def _zero_locked(self) -> None:
        self._counts = [0] * (len(self._bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
