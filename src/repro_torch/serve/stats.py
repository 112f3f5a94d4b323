"""Latency accounting for request batches: analytic ramp folding.

A 1M-request day cannot afford one Python object (or even one list
append) per request.  :class:`LatencyHist` exploits the fluid-queue shape
of a served batch: ``n`` requests drained at a constant rate ``r`` after
an initial wait ``w`` have latencies uniformly spread over
``(w, w + n/r]`` — a *ramp*.  Folding the ramp into a log-spaced
histogram costs O(buckets spanned), independent of ``n``, while p50/p99
come out of cumulative interpolation over the buckets.  Counts are floats
(a ramp may straddle a bucket edge fractionally); totals and the latency
sum are exact running accumulators.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List


class LatencyHist:
    """Log-bucketed latency histogram with O(span) batch folding.

    Buckets are geometric between ``lo_s`` and ``hi_s`` (latencies below
    ``lo_s`` land in the first bucket, above ``hi_s`` in the last), chosen
    to resolve ~10% relative error on quantiles across 1 ms .. 1 h — wide
    enough for any backlog a bounded autoscaler can build up.
    """

    def __init__(self, lo_s: float = 1e-3, hi_s: float = 3600.0, n_buckets: int = 96):
        if not (0 < lo_s < hi_s) or n_buckets < 2:
            raise ValueError("need 0 < lo_s < hi_s and >= 2 buckets")
        ratio = (hi_s / lo_s) ** (1.0 / (n_buckets - 1))
        # edges[i] = upper bound of bucket i; the last bucket is unbounded
        self.edges: List[float] = [lo_s * ratio**i for i in range(n_buckets - 1)]
        self.counts: List[float] = [0.0] * n_buckets
        self.total = 0.0
        self.sum_s = 0.0
        self.max_s = 0.0

    def _span_fold(self, lo: float, hi: float, weight: float) -> None:
        """Spread ``weight`` uniformly over latencies in ``[lo, hi]``."""
        edges, counts = self.edges, self.counts
        if hi <= lo:  # degenerate ramp: a point mass
            b = bisect.bisect_left(edges, lo)
            counts[b] += weight
            return
        density = weight / (hi - lo)
        b = bisect.bisect_left(edges, lo)
        cur = lo
        while cur < hi and b < len(edges):
            top = min(edges[b], hi)
            counts[b] += density * (top - cur)
            cur = top
            b += 1
        if cur < hi:  # overflow bucket
            counts[-1] += density * (hi - cur)

    def fold_ramp(self, wait_s: float, rate_rps: float, n: int) -> None:
        """Fold ``n`` requests drained at ``rate_rps`` req/s after an
        initial wait of ``wait_s`` seconds: latencies are the uniform ramp
        ``(wait_s, wait_s + n / rate_rps]``.

        ``rate_rps`` must be strictly positive and finite: a zero/negative
        drain rate (a deep-DVFS-throttled replica) has no ramp — folding
        ``n / rate_rps`` would either raise ``ZeroDivisionError`` or
        poison ``sum_s``/``max_s`` with ``inf``, corrupting every later
        quantile, so it is rejected loudly for the caller to handle.  The
        ramp top is clamped to ``hi_s`` semantics by construction: the
        overflow bucket absorbs everything above the last edge, while the
        exact accumulators keep the true (unclamped, finite) values."""
        if n <= 0:
            return
        if rate_rps <= 0.0 or not math.isfinite(rate_rps):
            raise ValueError(
                f"fold_ramp needs a positive finite drain rate, got "
                f"rate_rps={rate_rps!r} (throttled-to-stall replica?)"
            )
        span = n / rate_rps
        self._span_fold(wait_s, wait_s + span, float(n))
        self.total += n
        self.sum_s += n * (wait_s + span / 2.0)
        self.max_s = max(self.max_s, wait_s + span)

    def merge(self, other: "LatencyHist") -> None:
        """Fold ``other`` (same bucketisation) into this histogram."""
        if other.edges != self.edges:
            raise ValueError("cannot merge histograms with different buckets")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        self.sum_s += other.sum_s
        self.max_s = max(self.max_s, other.max_s)

    def quantile(self, q: float) -> float:
        """Latency (seconds) at quantile ``q`` in [0, 1], linearly
        interpolated within the containing bucket; 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.total <= 0:
            return 0.0
        target = q * self.total
        cum = 0.0
        lo = 0.0
        for b, c in enumerate(self.counts):
            hi = self.edges[b] if b < len(self.edges) else self.max_s
            if cum + c >= target and c > 0:
                frac = (target - cum) / c
                return lo + frac * (max(hi, lo) - lo)
            cum += c
            lo = hi
        return self.max_s

    @property
    def mean_s(self) -> float:
        """Exact mean latency in seconds (running accumulator, not from
        the bucketed counts); 0.0 when empty."""
        return self.sum_s / self.total if self.total else 0.0

    def summary(self) -> Dict[str, float]:
        """p50/p99/mean/max in milliseconds plus the folded count."""
        return {
            "count": self.total,
            "p50_ms": self.quantile(0.50) * 1e3,
            "p99_ms": self.quantile(0.99) * 1e3,
            "mean_ms": self.mean_s * 1e3,
            "max_ms": self.max_s * 1e3,
        }


def ramp_slo_violations(wait_s: float, rate_rps: float, n: int, slo_s: float) -> float:
    """Number of the ramp's ``n`` requests whose latency exceeds
    ``slo_s`` — exact under the uniform-ramp model, in [0, n].

    Same guard as :meth:`LatencyHist.fold_ramp`: a non-positive or
    non-finite drain rate has no ramp and raises ``ValueError`` instead of
    dividing by zero or returning a NaN violation count."""
    if n <= 0:
        return 0.0
    if rate_rps <= 0.0 or not math.isfinite(rate_rps):
        raise ValueError(
            f"ramp_slo_violations needs a positive finite drain rate, got "
            f"rate_rps={rate_rps!r} (throttled-to-stall replica?)"
        )
    span = n / rate_rps
    hi = wait_s + span
    if hi <= slo_s:
        return 0.0
    if wait_s >= slo_s:
        return float(n)
    return n * (hi - slo_s) / span
