"""Per-tenant-tier SLO targets + multi-window burn-rate monitors.

SRE-style burn-rate alerting over the trace stream: each tenant tier
declares latency targets (:class:`SloTarget` — TTFT and e2e thresholds
plus an attainment fraction), and :class:`SloMonitor` watches
``complete`` events through two (configurable) trailing windows.

**Burn rate** = (fraction of requests violating the threshold inside
the window) / (error budget), where error budget = 1 - attainment.
Burn 1.0 means the tier is consuming its budget exactly as fast as the
SLO allows; 6.0 means six times too fast. A tier's state is:

* ``page`` — *every* window burns >= ``page_burn`` (the classic
  multi-window AND: the short window proves it's happening *now*, the
  long window proves it's not a blip);
* ``warn`` — every window burns >= ``warn_burn``;
* ``ok``   — otherwise (including "no data yet": an idle tier has
  burned nothing).

This PR is report-only: :meth:`SloMonitor.status` is a pure probe the
router/admission *may* consume later (ROADMAP items 3/5); nothing here
mutates scheduling state. Timestamps are simulated seconds, same
clock as the rest of the trace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

from . import events as ev
from .series import SlidingWindow

#: monitored latency metrics (keys into SloTarget thresholds)
METRICS = ("ttft", "e2e")


@dataclass(frozen=True)
class SloTarget:
    """Latency thresholds (simulated seconds) + attainment fraction:
    "``attainment`` of requests must see ttft <= ``ttft`` and e2e <=
    ``e2e``"."""

    ttft: float
    e2e: float
    attainment: float = 0.95

    def __post_init__(self) -> None:
        if not 0.0 < self.attainment < 1.0:
            raise ValueError(
                f"attainment must be in (0, 1), got {self.attainment}")

    def threshold(self, metric: str) -> float:
        if metric == "ttft":
            return self.ttft
        if metric == "e2e":
            return self.e2e
        raise ValueError(f"unknown SLO metric {metric!r}")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.attainment


#: illustrative per-tier defaults for the L4-calibrated simulations —
#: premium pays for tight first-token + completion bounds, batch only
#: for eventual completion. Override per experiment.
DEFAULT_TARGETS: Dict[str, SloTarget] = {
    "premium": SloTarget(ttft=2.0, e2e=60.0, attainment=0.95),
    "standard": SloTarget(ttft=5.0, e2e=120.0, attainment=0.90),
    "batch": SloTarget(ttft=30.0, e2e=600.0, attainment=0.80),
}


class _MetricWindow:
    """Violation bookkeeping for one (tier, metric) over the trailing
    windows: total observations + violations per window."""

    def __init__(self, windows: Sequence[float]) -> None:
        self.seen = {w: SlidingWindow(w) for w in windows}
        self.violated = {w: SlidingWindow(w) for w in windows}

    def observe(self, ts: float, value: float, threshold: float) -> None:
        for w in self.seen.values():
            w.add(ts)
        if value > threshold:
            for w in self.violated.values():
                w.add(ts)

    def violation_fraction(self, window: float, now: float) -> float:
        n = self.seen[window].count(now)
        if n == 0:
            return 0.0
        return self.violated[window].count(now) / n


class SloMonitor:
    """Multi-window burn-rate monitor; attach as a recorder observer.

    Consumes ``complete`` events (their ``ttft`` / ``e2e`` payloads);
    requests with no TTFT anchor (atomic-batch runs) simply don't
    feed the ttft metric. ``windows`` are trailing spans in simulated
    seconds, shortest first by convention.
    """

    def __init__(self, targets: Optional[Mapping[str, SloTarget]] = None,
                 windows: Tuple[float, float] = (60.0, 600.0),
                 warn_burn: float = 1.0, page_burn: float = 6.0) -> None:
        if not windows:
            raise ValueError("need at least one window")
        self.targets = dict(targets if targets is not None
                            else DEFAULT_TARGETS)
        self.windows = tuple(windows)
        self.warn_burn = warn_burn
        self.page_burn = page_burn
        self._state: Dict[tuple, _MetricWindow] = {}
        self.last_ts = 0.0

    # ------------------------------------------------------------------
    def on_event(self, event) -> None:
        if event.ts > self.last_ts:
            self.last_ts = event.ts
        if event.kind != ev.COMPLETE or event.tenant is None:
            return
        self.observe(event.tenant, event.ts,
                     ttft=event.data.get("ttft"),
                     e2e=event.data.get("e2e"))

    def observe(self, tier: str, ts: float, *,
                ttft: Optional[float] = None,
                e2e: Optional[float] = None) -> None:
        target = self.targets.get(tier)
        if target is None:
            return
        for metric, value in (("ttft", ttft), ("e2e", e2e)):
            if value is None:
                continue
            key = (tier, metric)
            mw = self._state.get(key)
            if mw is None:
                mw = self._state[key] = _MetricWindow(self.windows)
            mw.observe(ts, value, target.threshold(metric))

    # ------------------------------------------------------------------
    def burn_rates(self, tier: str, metric: str,
                   now: Optional[float] = None) -> Dict[float, float]:
        """window -> burn rate (violation fraction / error budget);
        zeros when the tier/metric has no observations."""
        now = self.last_ts if now is None else now
        target = self.targets[tier]
        mw = self._state.get((tier, metric))
        if mw is None:
            return {w: 0.0 for w in self.windows}
        budget = max(target.error_budget, 1e-9)
        return {w: mw.violation_fraction(w, now) / budget
                for w in self.windows}

    def _verdict(self, burns: Dict[float, float]) -> str:
        vals = list(burns.values())
        if vals and all(b >= self.page_burn for b in vals):
            return "page"
        if vals and all(b >= self.warn_burn for b in vals):
            return "warn"
        return "ok"

    def status(self, now: Optional[float] = None) -> dict:
        """Pure probe: per-tier, per-metric burn rates + verdicts, plus
        a per-tier rollup (worst metric wins). JSON-ready."""
        now = self.last_ts if now is None else now
        rank = {"ok": 0, "warn": 1, "page": 2}
        out: dict = {}
        for tier in self.targets:
            metrics = {}
            worst = "ok"
            for metric in METRICS:
                burns = self.burn_rates(tier, metric, now)
                verdict = self._verdict(burns)
                mw = self._state.get((tier, metric))
                metrics[metric] = {
                    "burn": {f"{int(w)}s": b for w, b in burns.items()},
                    "state": verdict,
                    "n": (mw.seen[self.windows[0]].count(now)
                          if mw is not None else 0),
                }
                if rank[verdict] > rank[worst]:
                    worst = verdict
            out[tier] = {"state": worst, "metrics": metrics}
        return out
