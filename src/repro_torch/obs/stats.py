"""Shared exact statistics helpers (percentiles, fairness, batches).

These used to live in ``repro.serving.metrics``; they are the exact
(store-everything) counterparts of the streaming estimators in
:mod:`repro.obs.series` and are shared by run-level metrics, cluster
metrics, and the trace report CLI. ``repro.serving.metrics`` re-exports
them so existing imports keep working.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """Linear-interpolation percentile (numpy 'linear' method)."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    if len(xs) == 1:
        return xs[0]
    rank = (p / 100.0) * (len(xs) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1 - frac) + xs[hi] * frac


def jain_index(values: Sequence[float]) -> float:
    xs = [v for v in values if v is not None]
    if not xs:
        return float("nan")
    s = sum(xs)
    s2 = sum(v * v for v in xs)
    return (s * s) / (len(xs) * s2) if s2 > 0 else 1.0


@dataclass
class LatencyStats:
    n: int = 0
    mean: float = float("nan")
    p50: float = float("nan")
    p95: float = float("nan")
    p99: float = float("nan")

    @classmethod
    def of(cls, values: Sequence[float]) -> "LatencyStats":
        vals = [v for v in values if v is not None]
        if not vals:
            return cls()
        return cls(n=len(vals), mean=sum(vals) / len(vals),
                   p50=percentile(vals, 50), p95=percentile(vals, 95),
                   p99=percentile(vals, 99))

    def as_dict(self) -> dict:
        return {"n": self.n, "mean": self.mean, "p50": self.p50,
                "p95": self.p95, "p99": self.p99}
