"""Streaming windowed telemetry: P² quantiles, sliding windows, gauges.

The online counterpart of the exact end-of-run aggregation in
:mod:`repro.serving.metrics`: everything here is incremental (O(1)
memory per stream), which is what a feedback controller — proactive
scaling, SLO-aware admission — can actually consume *during* a run.

* :class:`P2Quantile` — Jain & Chlamtac's P² algorithm (1985): one
  streaming quantile from five markers, no sample storage. Exact for
  n <= 5 (falls back to linear interpolation over the stored seed
  values); for larger n the classic parabolic marker update applies.
  Accuracy is distribution-dependent; on the unimodal latency
  distributions here the estimate tracks the exact percentile to
  within a few percent of the sample range (bounds locked by
  ``tests/test_obs.py``, documented in ``docs/observability.md``).
* :class:`StreamSummary` — n / mean / min / max + P² p50/p95/p99 for
  one latency metric; ``as_dict()`` mirrors ``LatencyStats`` keys.
* :class:`SlidingWindow` — time-windowed (ts, value) pairs with O(1)
  amortised trim; rate / mean / sum over the trailing window.
* :class:`SeriesBank` — a :class:`~repro.obs.events.TraceRecorder`
  observer wiring trace events into the above: TTFT / e2e /
  inter-token streams, drift MAE window, prefix hit-rate window,
  arrival & shed rates, and last-value gauges (queue depth per tier,
  slot occupancy, free pages, ...).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Optional

from . import events as ev
from .stats import percentile


class P2Quantile:
    """Single streaming quantile via the P² algorithm.

    Five markers track (min, p/2, p, (1+p)/2, max); marker heights
    adjust by a piecewise-parabolic prediction as observations arrive.
    ``add`` is O(1); ``value`` is O(1) after the first five samples.
    """

    def __init__(self, p: float) -> None:
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = p
        self.n = 0
        self._seed: List[float] = []       # first five observations
        self._q: List[float] = []          # marker heights
        self._pos: List[float] = []        # marker positions (1-based)
        self._want: List[float] = []       # desired positions
        self._dn = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]

    def add(self, x: float) -> None:
        self.n += 1
        if self.n <= 5:
            self._seed.append(x)
            if self.n == 5:
                self._seed.sort()
                self._q = list(self._seed)
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._want = [1.0 + 4.0 * d for d in self._dn]
            return
        q, pos = self._q, self._pos
        # cell k: which marker interval x falls in; extremes clamp
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._dn[i]
        # adjust interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
                    (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                sign = 1.0 if d >= 1.0 else -1.0
                cand = self._parabolic(i, sign)
                if q[i - 1] < cand < q[i + 1]:
                    q[i] = cand
                else:
                    q[i] = self._linear(i, sign)
                pos[i] += sign

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self._q, self._pos
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        q, n = self._q, self._pos
        j = i + int(d)
        return q[i] + d * (q[j] - q[i]) / (n[j] - n[i])

    def value(self) -> float:
        """Current estimate (NaN when empty; exact for n <= 5)."""
        if self.n == 0:
            return float("nan")
        if self.n <= 5:
            return percentile(self._seed, self.p * 100.0)
        return self._q[2]


class StreamSummary:
    """Streaming n/mean/min/max + P² p50/p95/p99 for one metric."""

    QUANTILES = (0.50, 0.95, 0.99)

    def __init__(self) -> None:
        self.n = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._q = {p: P2Quantile(p) for p in self.QUANTILES}

    def add(self, x: float) -> None:
        self.n += 1
        self.total += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        for q in self._q.values():
            q.add(x)

    def quantile(self, p: float) -> float:
        return self._q[p].value()

    def as_dict(self) -> dict:
        if self.n == 0:
            return {"n": 0, "mean": float("nan"), "p50": float("nan"),
                    "p95": float("nan"), "p99": float("nan")}
        return {"n": self.n, "mean": self.total / self.n,
                "p50": self._q[0.50].value(),
                "p95": self._q[0.95].value(),
                "p99": self._q[0.99].value(),
                "min": self.min, "max": self.max}


class SlidingWindow:
    """(ts, value) pairs over a trailing time window."""

    def __init__(self, window: float) -> None:
        if window <= 0:
            raise ValueError(f"window must be > 0, got {window}")
        self.window = window
        self._buf: deque = deque()
        self._sum = 0.0

    def add(self, ts: float, value: float = 1.0) -> None:
        self._buf.append((ts, value))
        self._sum += value
        self.trim(ts)

    def trim(self, now: float) -> None:
        cutoff = now - self.window
        buf = self._buf
        while buf and buf[0][0] < cutoff:
            self._sum -= buf.popleft()[1]

    def count(self, now: float) -> int:
        self.trim(now)
        return len(self._buf)

    def sum(self, now: float) -> float:
        self.trim(now)
        return self._sum

    def mean(self, now: float) -> float:
        self.trim(now)
        return self._sum / len(self._buf) if self._buf else float("nan")

    def rate(self, now: float) -> float:
        """Events per second over the trailing window."""
        return self.count(now) / self.window


class SeriesBank:
    """Recorder observer: trace events -> streaming aggregates.

    Attach via ``TraceRecorder(observers=[bank])`` (or
    ``add_observer``); observers see every emission pre-sampling, so
    these aggregates are exact regardless of ring thinning.
    """

    def __init__(self, window: float = 60.0) -> None:
        self.window = window
        self.ttft = StreamSummary()
        self.e2e = StreamSummary()
        self.inter_token = StreamSummary()
        self.drift_abs_error = SlidingWindow(window)   # -> windowed MAE
        self.prefix_hits = SlidingWindow(window)
        self.prefix_misses = SlidingWindow(window)
        self.arrivals = SlidingWindow(window)
        self.sheds = SlidingWindow(window)
        self.completions = SlidingWindow(window)
        # gauge name -> (ts, last value); per-tier queue depth, slot
        # occupancy, free pages etc. arrive through GAUGE events
        self.gauges: Dict[str, tuple] = {}
        self.last_ts = 0.0

    def on_event(self, event) -> None:
        k = event.kind
        ts = event.ts
        if ts > self.last_ts:
            self.last_ts = ts
        if k == ev.COMPLETE:
            d = event.data
            if d.get("e2e") is not None:
                self.e2e.add(d["e2e"])
            if d.get("ttft") is not None:
                self.ttft.add(d["ttft"])
            if d.get("inter_token") is not None:
                self.inter_token.add(d["inter_token"])
            self.completions.add(ts)
        elif k == ev.ARRIVE:
            self.arrivals.add(ts)
        elif k == ev.SHED:
            self.sheds.add(ts)
        elif k == ev.DRIFT:
            self.drift_abs_error.add(ts, event.data.get("abs_error", 0.0))
        elif k == ev.PREFIX_HIT:
            self.prefix_hits.add(ts)
        elif k == ev.PREFIX_MISS:
            self.prefix_misses.add(ts)
        elif k == ev.GAUGE:
            self.gauges[event.data["name"]] = (ts, event.data["value"])

    # ------------------------------------------------------------------
    def prefix_hit_rate(self, now: Optional[float] = None) -> float:
        now = self.last_ts if now is None else now
        h = self.prefix_hits.count(now)
        m = self.prefix_misses.count(now)
        return h / (h + m) if h + m else float("nan")

    def drift_mae(self, now: Optional[float] = None) -> float:
        now = self.last_ts if now is None else now
        return self.drift_abs_error.mean(now)

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Point-in-time view of every stream (JSON-ready; NaN for
        empty streams — sanitized to null by the benchmark writer)."""
        now = self.last_ts if now is None else now
        return {
            "ts": now,
            "window_s": self.window,
            "ttft": self.ttft.as_dict(),
            "e2e": self.e2e.as_dict(),
            "inter_token": self.inter_token.as_dict(),
            "windowed": {
                "arrival_rate": self.arrivals.rate(now),
                "shed_rate": self.sheds.rate(now),
                "completion_rate": self.completions.rate(now),
                "drift_mae": self.drift_mae(now),
                "prefix_hit_rate": self.prefix_hit_rate(now),
            },
            "gauges": {name: {"ts": t, "value": v}
                       for name, (t, v) in sorted(self.gauges.items())},
        }
