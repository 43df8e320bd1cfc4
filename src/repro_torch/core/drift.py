"""Runtime token-drift measurement (Sec. II-J, Table VII).

Tracks (estimated_output, observed_output) pairs for every completed
request and computes the estimation-error metrics the paper reports:

* MAE  = mean |est - obs|
* RMSE = sqrt(mean (est - obs)^2)

Errors are tracked overall and per semantic category, and as a running
time-series so Fig. 8 (estimated vs observed under BIAS=OFF/ON) can be
re-created. The BIAS=OFF vs BIAS=ON *reduction* percentages of Table VII
are computed by :func:`error_reduction` over two runs' metrics.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .request import Category, Request


@dataclass
class DriftSample:
    """One completed request's estimation record."""

    time: float
    category: str
    estimated_output: float
    observed_output: float
    t_budget: float
    prompt_tokens: int
    # serving phase that observed the output length ("unified", or
    # "decode" when a P/D decode replica saw the request finish)
    phase: str = "unified"
    # prefix-cache attribution: the overlap priced into t_budget at
    # placement vs the hit actually taken at prefill. The bias EMA is
    # cache-neutral by construction — feedback is observed OUTPUT
    # tokens (Eq. 6), which a cached prefill does not change — so cache
    # luck can never masquerade as systematic output drift; these
    # fields exist so budget-error analyses can split the hit/miss
    # populations (and audit expectation-vs-realization) instead of
    # averaging cache fortune into the drift numbers.
    expected_cached_tokens: int = 0
    cached_tokens: int = 0

    @property
    def cache_hit(self) -> bool:
        return self.cached_tokens > 0

    @property
    def error(self) -> float:
        return self.estimated_output - self.observed_output

    @property
    def abs_error(self) -> float:
        return abs(self.error)


@dataclass
class ErrorStats:
    n: int = 0
    mae: float = 0.0
    rmse: float = 0.0
    mean_error: float = 0.0  # signed: >0 means over-estimation

    def as_dict(self) -> dict:
        return {
            "n": self.n, "mae": self.mae, "rmse": self.rmse,
            "mean_error": self.mean_error,
        }


class DriftTracker:
    """Accumulates drift samples during an experiment run.

    Owners that trace (worker simulators, serving engines) attach a
    live recorder as ``self.trace`` (plus their replica id as
    ``self.trace_rid``) so every drift sample also lands in the
    lifecycle trace — this is the drift-MAE stream the observability
    layer's sliding windows consume."""

    def __init__(self) -> None:
        self.samples: List[DriftSample] = []
        # observability hooks: no-op sentinel unless an owner attaches
        # a live recorder (imported lazily to keep core dependency-lean)
        from ..obs.events import NULL_RECORDER
        self.trace = NULL_RECORDER
        self.trace_rid: Optional[int] = None

    def record(self, req: Request, now: float,
               phase: str = "unified") -> DriftSample:
        if req.estimate is None or req.observed_output_tokens is None:
            raise ValueError(f"request {req.req_id} incomplete for drift record")
        s = DriftSample(
            time=now,
            category=req.category.value,
            estimated_output=req.estimate.est_output_tokens,
            observed_output=float(req.observed_output_tokens),
            t_budget=req.estimate.t_budget,
            prompt_tokens=req.prompt_tokens,
            phase=phase,
            expected_cached_tokens=req.estimate.cached_tokens,
            cached_tokens=req.cached_prompt_tokens,
        )
        self.samples.append(s)
        if self.trace.enabled:
            from ..obs import events as _tr
            self.trace.emit(now, _tr.DRIFT, req_id=req.req_id,
                            rid=self.trace_rid, tenant=req.tenant.label,
                            category=s.category, phase=phase,
                            estimated=s.estimated_output,
                            observed=s.observed_output,
                            abs_error=s.abs_error)
        return s

    # ------------------------------------------------------------------
    def stats(self, category: Optional[Category] = None,
              after: float = -math.inf, before: float = math.inf) -> ErrorStats:
        cat = category.value if category is not None else None
        sel = [s for s in self.samples
               if (cat is None or s.category == cat) and after <= s.time < before]
        if not sel:
            return ErrorStats()
        n = len(sel)
        mae = sum(s.abs_error for s in sel) / n
        rmse = math.sqrt(sum(s.error ** 2 for s in sel) / n)
        mean_err = sum(s.error for s in sel) / n
        return ErrorStats(n=n, mae=mae, rmse=rmse, mean_error=mean_err)

    def per_category(self) -> Dict[str, ErrorStats]:
        return {c.value: self.stats(c) for c in Category}

    def per_cache_outcome(self) -> Dict[str, ErrorStats]:
        """Estimation error split by prefix-cache outcome, so cache
        luck is inspectable instead of averaged into the drift numbers
        (output-bias calibration itself is cache-neutral: Eq. 6 feeds
        on observed output tokens only)."""
        def _stats(sel: List[DriftSample]) -> ErrorStats:
            if not sel:
                return ErrorStats()
            n = len(sel)
            return ErrorStats(
                n=n,
                mae=sum(s.abs_error for s in sel) / n,
                rmse=math.sqrt(sum(s.error ** 2 for s in sel) / n),
                mean_error=sum(s.error for s in sel) / n)
        return {"hit": _stats([s for s in self.samples if s.cache_hit]),
                "miss": _stats([s for s in self.samples
                                if not s.cache_hit])}

    def misclassification_rate(self, classify_fn) -> float:
        """Fraction of requests whose *runtime* class (from the observed
        budget: prompt + observed output) differs from the admission-time
        class (Fig. 2's misclassification phenomenon)."""
        if not self.samples:
            return 0.0
        wrong = 0
        for s in self.samples:
            predicted = classify_fn(s.t_budget)
            actual = classify_fn(s.prompt_tokens + s.observed_output)
            if predicted != actual:
                wrong += 1
        return wrong / len(self.samples)


def error_reduction(off: ErrorStats, on: ErrorStats) -> Dict[str, float]:
    """Table VII: percentage reduction BIAS=OFF -> BIAS=ON."""

    def pct(a: float, b: float) -> float:
        return 100.0 * (a - b) / a if a > 0 else 0.0

    return {
        "mae_reduction_pct": pct(off.mae, on.mae),
        "rmse_reduction_pct": pct(off.rmse, on.rmse),
    }
