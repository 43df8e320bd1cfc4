"""Run-level metrics aggregation (Sec. II-I / IV).

Computes everything the paper's tables report from a list of completed
requests: latency percentiles (P50/P95/P99), queue waits, per-tenant
and per-job-class breakdowns, GPU execution latency, throughput, and
Jain's fairness index over tenant latencies — plus the step-engine
streaming stats the paper could not observe at batch granularity:
decode-phase latency and the per-request mean inter-token gap
(``Request.inter_token_latency``), both empty on legacy atomic unified
runs where no first-token anchor exists.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from ..core.request import JobClass, Request, TenantTier
# the exact-statistics helpers moved to the shared observability layer
# (repro.obs.stats); re-exported here so existing imports keep working
from ..obs.stats import LatencyStats, jain_index, percentile

__all__ = ["LatencyStats", "RunMetrics", "jain_index", "percentile",
           "summarize_run", "summarize_run_arrays"]


@dataclass
class RunMetrics:
    """Everything a benchmark needs from one experiment run."""

    policy: str
    bias_enabled: bool
    e2e: LatencyStats
    queue_wait: LatencyStats
    gpu_exec: LatencyStats
    per_tenant: Dict[str, dict]
    per_class_wait: Dict[str, float]
    throughput_rps: float
    gpu_utilization: float
    fairness: float
    n_completed: int
    n_failed_dispatches: int
    makespan: float
    # step-engine streaming stats (empty when no first-token anchor
    # exists, i.e. legacy atomic unified runs): decode span per request
    # and the mean inter-token gap over its `observed - 1` gaps
    decode: LatencyStats = field(default_factory=LatencyStats)
    inter_token: LatencyStats = field(default_factory=LatencyStats)

    def as_dict(self) -> dict:
        return {
            "policy": self.policy,
            "bias_enabled": self.bias_enabled,
            "e2e": self.e2e.as_dict(),
            "queue_wait": self.queue_wait.as_dict(),
            "gpu_exec": self.gpu_exec.as_dict(),
            "per_tenant": self.per_tenant,
            "per_class_wait": self.per_class_wait,
            "throughput_rps": self.throughput_rps,
            "gpu_utilization": self.gpu_utilization,
            "fairness": self.fairness,
            "n_completed": self.n_completed,
            "n_failed_dispatches": self.n_failed_dispatches,
            "makespan": self.makespan,
            "decode": self.decode.as_dict(),
            "inter_token": self.inter_token.as_dict(),
        }


def summarize_run(policy: str, bias_enabled: bool,
                  completed: Iterable[Request], *,
                  busy_time: float = 0.0,
                  n_failed_dispatches: int = 0) -> RunMetrics:
    reqs = list(completed)
    e2e = [r.e2e_latency for r in reqs]
    waits = [r.queue_wait for r in reqs]
    execs = [r.gpu_latency for r in reqs]

    per_tenant = {}
    for tier in TenantTier:
        sel = [r for r in reqs if r.tenant == tier]
        per_tenant[tier.label] = {
            "latency": LatencyStats.of([r.e2e_latency for r in sel]).as_dict(),
            "queue_wait": LatencyStats.of([r.queue_wait for r in sel]).as_dict(),
        }

    per_class = {}
    for jc in JobClass:
        sel = [r.queue_wait for r in reqs
               if r.estimate and r.estimate.job_class == jc]
        sel = [w for w in sel if w is not None]
        per_class[jc.value] = sum(sel) / len(sel) if sel else float("nan")

    makespan = max((r.completion_time for r in reqs
                    if r.completion_time is not None), default=0.0)
    tenant_means = [per_tenant[t.label]["latency"]["mean"]
                    for t in TenantTier
                    if per_tenant[t.label]["latency"]["n"] > 0]

    return RunMetrics(
        policy=policy,
        bias_enabled=bias_enabled,
        e2e=LatencyStats.of(e2e),
        queue_wait=LatencyStats.of(waits),
        gpu_exec=LatencyStats.of(execs),
        per_tenant=per_tenant,
        per_class_wait=per_class,
        throughput_rps=len(reqs) / makespan if makespan > 0 else 0.0,
        gpu_utilization=busy_time / makespan if makespan > 0 else 0.0,
        fairness=jain_index(tenant_means),
        n_completed=len(reqs),
        n_failed_dispatches=n_failed_dispatches,
        makespan=makespan,
        decode=LatencyStats.of([r.decode_latency for r in reqs]),
        inter_token=LatencyStats.of([r.inter_token_latency for r in reqs]),
    )


def _nan_to_none(a) -> List[Optional[float]]:
    """NaN -> None for array-to-stats handoff. CRITICAL for parity:
    :meth:`LatencyStats.of` filters None (the object world's missing
    value) but would happily average a NaN through."""
    import math
    return [None if math.isnan(x) else x for x in a.tolist()]


def summarize_run_arrays(policy: str, bias_enabled: bool, state,
                         order, *, busy_time: float = 0.0,
                         n_failed_dispatches: int = 0) -> RunMetrics:
    """Array-core twin of :func:`summarize_run`: computes the same
    :class:`RunMetrics` from ``repro.serving.vector_sim.VectorState``
    columns and a completion-order index array, bit-identically.

    Per-request quantities are single IEEE subtractions/divisions on
    float64 columns — the same operations the ``Request`` latency
    properties perform on the same values — and the reductions reuse
    the exact :class:`LatencyStats`/:func:`jain_index` helpers (Python
    sequential sums), so a vector run and an object run with identical
    event trajectories summarize to identical metrics."""
    import math

    import numpy as np

    order = np.asarray(order, dtype=np.int64)
    comp = state.completion[order]
    arrival = state.arrival[order]
    e2e_a = comp - arrival
    waits_a = state.dispatch[order] - arrival
    execs_a = state.exec_end[order] - state.exec_start[order]
    decode_a = comp - state.prefill_end[order]
    obs = state.observed[order].astype(np.float64)
    with np.errstate(invalid="ignore"):
        inter_a = np.where(obs > 1.0,
                           decode_a / np.maximum(obs - 1.0, 1.0), np.nan)

    tenants = state.tenant[order]
    per_tenant = {}
    for tier in TenantTier:
        m = tenants == int(tier)
        per_tenant[tier.label] = {
            "latency": LatencyStats.of(_nan_to_none(e2e_a[m])).as_dict(),
            "queue_wait": LatencyStats.of(
                _nan_to_none(waits_a[m])).as_dict(),
        }

    classes = state.job_class[order]
    per_class = {}
    for code, jc in enumerate(JobClass):
        sel = [w for w in waits_a[classes == code].tolist()
               if not math.isnan(w)]
        per_class[jc.value] = sum(sel) / len(sel) if sel else float("nan")

    n = int(order.shape[0])
    makespan = float(np.max(comp)) if n else 0.0
    tenant_means = [per_tenant[t.label]["latency"]["mean"]
                    for t in TenantTier
                    if per_tenant[t.label]["latency"]["n"] > 0]

    return RunMetrics(
        policy=policy,
        bias_enabled=bias_enabled,
        e2e=LatencyStats.of(_nan_to_none(e2e_a)),
        queue_wait=LatencyStats.of(_nan_to_none(waits_a)),
        gpu_exec=LatencyStats.of(_nan_to_none(execs_a)),
        per_tenant=per_tenant,
        per_class_wait=per_class,
        throughput_rps=n / makespan if makespan > 0 else 0.0,
        gpu_utilization=busy_time / makespan if makespan > 0 else 0.0,
        fairness=jain_index(tenant_means),
        n_completed=n,
        n_failed_dispatches=n_failed_dispatches,
        makespan=makespan,
        decode=LatencyStats.of(_nan_to_none(decode_a)),
        inter_token=LatencyStats.of(_nan_to_none(inter_a)),
    )
