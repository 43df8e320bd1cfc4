"""Global admission: the cluster front door (rate limits + backpressure).

Sits *before* the router. Two gates, applied in order:

1. **Cluster-depth backpressure** — when the total outstanding
   estimated-token mass across routable replicas exceeds
   ``max_cluster_token_mass``, new work is shed rather than queued into
   an already-saturated cluster (bounded queues; the single-replica
   paper protocol deliberately unbounds them to study drift under
   saturation, the cluster layer must not).
2. **Per-tenant token buckets** — each tenant tier owns a bucket that
   refills in *estimated budget tokens* per second (Eq. 1 pricing from
   the shared estimator, so rate limiting is drift-calibrated too: a
   tenant whose jobs run long is charged more per request as the bias
   learns that). A request is shed when its tier's bucket cannot cover
   its estimated budget.

Shed requests are marked ``CANCELLED`` and accounted per tier and per
reason — the shed-rate numbers the cluster benchmark reports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

from ..core.request import Request, RequestState, TenantTier
from ..obs import events as _tr
from ..obs import resolve_recorder

SHED_RATE_LIMIT = "rate_limited"
SHED_BACKPRESSURE = "backpressure"
SHED_NO_REPLICA = "no_replica"


@dataclass(frozen=True)
class AdmissionConfig:
    """Front-door limits. Defaults are generous enough that the paper's
    single-replica protocol would pass untouched; stress configurations
    tighten them."""

    # token-bucket capacity (burst) per tier, in estimated budget tokens
    bucket_capacity: Mapping[TenantTier, float] = field(
        default_factory=lambda: {
            TenantTier.PREMIUM: 120_000.0,
            TenantTier.STANDARD: 90_000.0,
            TenantTier.BATCH: 60_000.0,
        })
    # sustained refill, estimated budget tokens per second
    refill_rate: Mapping[TenantTier, float] = field(
        default_factory=lambda: {
            TenantTier.PREMIUM: 4_000.0,
            TenantTier.STANDARD: 3_000.0,
            TenantTier.BATCH: 2_000.0,
        })
    # cluster-wide outstanding estimated-token mass ceiling
    max_cluster_token_mass: float = float("inf")


class TokenBucket:
    """Deterministic continuous-refill token bucket."""

    def __init__(self, capacity: float, rate: float) -> None:
        self.capacity = float(capacity)
        self.rate = float(rate)
        self.level = float(capacity)
        self._t_last = 0.0

    def _refill(self, now: float) -> None:
        if now > self._t_last:
            self.level = min(self.capacity,
                             self.level + self.rate * (now - self._t_last))
            self._t_last = now

    def try_consume(self, cost: float, now: float) -> bool:
        """Debit ``cost`` (estimated budget tokens, Eq. 1 pricing from
        the shared estimator) after refilling to ``now`` (seconds);
        False (no debit) when the bucket cannot cover it."""
        self._refill(now)
        if cost <= self.level:
            self.level -= cost
            return True
        return False

    def peek(self, now: float) -> float:
        """Current level in estimated budget tokens, refilled to
        ``now`` (seconds) without consuming."""
        self._refill(now)
        return self.level


@dataclass
class ShedRecord:
    """One rejected request (per-tier accounting, Sec. II-I style log)."""

    time: float
    req_id: int
    tenant: str
    reason: str
    est_budget: float


class GlobalAdmission:
    """Tenant-rate-limited, backpressure-aware front door."""

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 trace=None) -> None:
        self.cfg = config or AdmissionConfig()
        self.trace = resolve_recorder(trace)
        self.buckets: Dict[TenantTier, TokenBucket] = {
            t: TokenBucket(self.cfg.bucket_capacity[t],
                           self.cfg.refill_rate[t])
            for t in TenantTier
        }
        self.accepted: Dict[TenantTier, int] = {t: 0 for t in TenantTier}
        self.shed: Dict[TenantTier, Dict[str, int]] = {
            t: {} for t in TenantTier}
        self.shed_log: List[ShedRecord] = []

    # ------------------------------------------------------------------
    def offer(self, req: Request, est_budget: float, now: float,
              cluster_token_mass: float) -> Tuple[bool, Optional[str]]:
        """Admit or shed. Returns (admitted, shed_reason)."""
        if cluster_token_mass + est_budget > self.cfg.max_cluster_token_mass:
            return False, self._shed(req, SHED_BACKPRESSURE, est_budget, now)
        if not self.buckets[req.tenant].try_consume(est_budget, now):
            return False, self._shed(req, SHED_RATE_LIMIT, est_budget, now)
        self.accepted[req.tenant] += 1
        if self.trace.enabled:
            self.trace.emit(now, _tr.ADMIT, req_id=req.req_id,
                            tenant=req.tenant.label,
                            est_budget=est_budget)
        return True, None

    def shed_no_replica(self, req: Request, est_budget: float,
                        now: float) -> str:
        """Router found no routable replica (total outage) for an
        already-admitted request: roll back the bucket debit and the
        accept count so the outage is not also charged against the
        tenant's rate limit, then account the shed."""
        bucket = self.buckets[req.tenant]
        bucket._refill(now)
        bucket.level = min(bucket.capacity, bucket.level + est_budget)
        self.accepted[req.tenant] -= 1
        return self._shed(req, SHED_NO_REPLICA, est_budget, now)

    def _shed(self, req: Request, reason: str, est_budget: float,
              now: float) -> str:
        req.state = RequestState.CANCELLED
        per_tier = self.shed[req.tenant]
        per_tier[reason] = per_tier.get(reason, 0) + 1
        self.shed_log.append(ShedRecord(
            time=now, req_id=req.req_id, tenant=req.tenant.label,
            reason=reason, est_budget=est_budget))
        if self.trace.enabled:
            self.trace.emit(now, _tr.SHED, req_id=req.req_id,
                            tenant=req.tenant.label, reason=reason,
                            est_budget=est_budget)
        return reason

    # --- accounting ----------------------------------------------------
    def n_shed(self, tenant: Optional[TenantTier] = None) -> int:
        """Requests shed (count), for one tier or all tiers."""
        tiers = [tenant] if tenant is not None else list(TenantTier)
        return sum(sum(self.shed[t].values()) for t in tiers)

    def n_accepted(self, tenant: Optional[TenantTier] = None) -> int:
        """Requests admitted (count), for one tier or all tiers."""
        tiers = [tenant] if tenant is not None else list(TenantTier)
        return sum(self.accepted[t] for t in tiers)

    def shed_rate(self, tenant: Optional[TenantTier] = None) -> float:
        """shed / (shed + accepted) in [0, 1]; 0.0 with no traffic."""
        shed = self.n_shed(tenant)
        total = shed + self.n_accepted(tenant)
        return shed / total if total else 0.0

    def summary(self) -> dict:
        """JSON-ready accept/shed accounting: counts per tier, shed
        reasons per tier, and overall + per-tier shed rates."""
        return {
            "accepted": {t.label: self.accepted[t] for t in TenantTier},
            "shed": {t.label: dict(self.shed[t]) for t in TenantTier},
            "shed_rate": self.shed_rate(),
            "shed_rate_per_tier": {t.label: self.shed_rate(t)
                                   for t in TenantTier},
        }
