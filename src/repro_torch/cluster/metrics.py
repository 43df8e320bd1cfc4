"""Cluster-level metrics: per-run aggregation across N replicas.

Wraps the single-run :func:`repro.serving.metrics.summarize_run` (same
latency/fairness definitions, so cluster numbers are directly
comparable with the paper tables) and adds the cluster-only dimensions:
shed accounting per tier, per-replica utilization and routing share,
and the autoscaler's action trail.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..core.request import Request
from ..serving.metrics import LatencyStats, RunMetrics, summarize_run
from .admission import GlobalAdmission
from .autoscaler import Autoscaler


@dataclass
class ReplicaStats:
    """Per-replica run accounting: role, routing share, completions,
    busy seconds, utilization (busy_time / makespan), and the P/D
    handoff + work-stealing flow counters."""

    rid: int
    state: str
    n_routed: int
    n_completed: int
    busy_time: float
    utilization: float               # busy_time / makespan
    role: str = "unified"
    n_handoffs_in: int = 0
    n_handoffs_out: int = 0
    n_stolen_in: int = 0
    n_stolen_away: int = 0
    # shared-prefix KV cache counters (all zero when disabled):
    # request-granular hits/misses, prefill tokens served from cache,
    # LRU-evicted pages, failure-driven cache wipes
    n_prefix_hits: int = 0
    n_prefix_misses: int = 0
    prefix_tokens_saved: int = 0
    prefix_evicted_pages: int = 0
    prefix_invalidations: int = 0

    def as_dict(self) -> dict:
        """JSON-ready flat dict (benchmark --json capture)."""
        return {"rid": self.rid, "state": self.state, "role": self.role,
                "n_routed": self.n_routed, "n_completed": self.n_completed,
                "busy_time": self.busy_time, "utilization": self.utilization,
                "n_handoffs_in": self.n_handoffs_in,
                "n_handoffs_out": self.n_handoffs_out,
                "n_stolen_in": self.n_stolen_in,
                "n_stolen_away": self.n_stolen_away,
                "n_prefix_hits": self.n_prefix_hits,
                "n_prefix_misses": self.n_prefix_misses,
                "prefix_tokens_saved": self.prefix_tokens_saved,
                "prefix_evicted_pages": self.prefix_evicted_pages,
                "prefix_invalidations": self.prefix_invalidations}


@dataclass
class ClusterMetrics:
    """One cluster run: the familiar RunMetrics plus cluster extras.

    The per-phase breakdown (all in seconds since arrival):

    * ``ttft`` — time to first token. Real (end of the prefill phase)
      on the P/D path, and real on unified replicas running the
      iteration-level step engine (``ClusterConfig.step_engine``: the
      iteration that emitted the request's first token). Only on the
      legacy atomic path does the cost model observe the first token at
      batch end, degrading unified TTFT to e2e — that asymmetry *is*
      the head-of-line effect both disaggregation and chunked-prefill
      continuous batching remove (compare them head-to-head with
      ``benchmarks.bench_chunked_prefill``).
    * ``decode`` — decode-phase span: KV arrival on the decode replica
      → completion on the P/D path (decode queueing + execution), first
      token → completion on step-engine unified replicas; empty only on
      legacy atomic unified runs.
    * ``inter_token`` — per-request mean inter-token gap (the decode
      span over its ``observed - 1`` gaps): the streaming-jitter stat
      TTFT alone cannot show. Same anchors as ``decode``.
    * ``kv_transfer`` — modeled prefill→decode transfer time.

    ``prefix_cache`` aggregates the shared-prefix KV-reuse counters
    across replicas (request hit rate, prefill tokens served from
    cache, LRU evictions, failure invalidations); all zero when
    ``ClusterConfig.prefix_cache`` is off.
    """

    routing: str
    n_replicas_start: int
    n_replicas_end: int
    run: RunMetrics
    shed: dict                       # GlobalAdmission.summary()
    replicas: List[ReplicaStats]
    scale_events: List[dict]
    n_rerouted: int
    ttft: LatencyStats = field(default_factory=LatencyStats)
    decode: LatencyStats = field(default_factory=LatencyStats)
    inter_token: LatencyStats = field(default_factory=LatencyStats)
    kv_transfer: LatencyStats = field(default_factory=LatencyStats)
    n_handoffs: int = 0
    n_handoffs_lost: int = 0
    n_stolen: int = 0
    prefix_cache: dict = field(default_factory=dict)
    # execution-core backend the replicas ran on ("object" | "vector")
    # — recorded so --json benchmark captures are self-describing
    backend: str = "object"

    @property
    def shed_rate(self) -> float:
        """Fraction of offered requests the front door shed."""
        return self.shed.get("shed_rate", 0.0)

    def as_dict(self) -> dict:
        """JSON-ready nested dict (benchmark --json capture)."""
        return {
            "routing": self.routing,
            "n_replicas_start": self.n_replicas_start,
            "n_replicas_end": self.n_replicas_end,
            "run": self.run.as_dict(),
            "shed": self.shed,
            "replicas": [r.as_dict() for r in self.replicas],
            "scale_events": self.scale_events,
            "n_rerouted": self.n_rerouted,
            "ttft": self.ttft.as_dict(),
            "decode": self.decode.as_dict(),
            "inter_token": self.inter_token.as_dict(),
            "kv_transfer": self.kv_transfer.as_dict(),
            "n_handoffs": self.n_handoffs,
            "n_handoffs_lost": self.n_handoffs_lost,
            "n_stolen": self.n_stolen,
            "prefix_cache": dict(self.prefix_cache),
            "backend": self.backend,
        }


def summarize_cluster(routing: str, policy: str, bias_enabled: bool,
                      completed: Sequence[Request], *,
                      replicas, admission: Optional[GlobalAdmission],
                      autoscaler: Optional[Autoscaler],
                      n_replicas_start: int,
                      replica_busy_time: Dict[int, float],
                      replica_completed: Dict[int, int],
                      n_failed_dispatches: int = 0,
                      n_rerouted: int = 0,
                      n_handoffs: int = 0,
                      n_handoffs_lost: int = 0,
                      n_stolen: int = 0,
                      backend: str = "object") -> ClusterMetrics:
    """Aggregate one cluster run into :class:`ClusterMetrics`.

    ``completed`` are the finished requests across every replica (their
    timestamps, in seconds, drive all latency stats); ``replica_busy_time``
    maps rid -> busy seconds; handoff/steal counts come from the cluster
    simulator's flow counters.
    """
    run = summarize_run(policy, bias_enabled, completed,
                        busy_time=(sum(replica_busy_time.values())
                                   / max(len(replica_busy_time), 1)),
                        n_failed_dispatches=n_failed_dispatches)
    makespan = max(run.makespan, 1e-9)
    stats = []
    prefix_totals = {"hits": 0, "misses": 0, "tokens_saved": 0,
                     "evicted_pages": 0, "invalidations": 0}
    for r in replicas:
        pc = r.prefix_cache_stats()
        for k in prefix_totals:
            prefix_totals[k] += pc.get(k, 0)
        stats.append(ReplicaStats(
            rid=r.rid, state=r.state.value, role=r.role.value,
            n_routed=r.n_routed,
            n_completed=replica_completed.get(r.rid, 0),
            busy_time=replica_busy_time.get(r.rid, 0.0),
            utilization=replica_busy_time.get(r.rid, 0.0) / makespan,
            n_handoffs_in=r.n_handoffs_in, n_handoffs_out=r.n_handoffs_out,
            n_stolen_in=r.n_stolen_in, n_stolen_away=r.n_stolen_away,
            n_prefix_hits=pc.get("hits", 0),
            n_prefix_misses=pc.get("misses", 0),
            prefix_tokens_saved=pc.get("tokens_saved", 0),
            prefix_evicted_pages=pc.get("evicted_pages", 0),
            prefix_invalidations=pc.get("invalidations", 0)))
    probed = prefix_totals["hits"] + prefix_totals["misses"]
    prefix_totals["hit_rate"] = (prefix_totals["hits"] / probed
                                 if probed else 0.0)
    from .replica import ReplicaState
    n_end = sum(1 for r in replicas
                if r.state in (ReplicaState.ACTIVE, ReplicaState.STARTING))
    return ClusterMetrics(
        routing=routing,
        n_replicas_start=n_replicas_start,
        n_replicas_end=n_end,
        run=run,
        shed=admission.summary() if admission is not None else {
            "accepted": {}, "shed": {}, "shed_rate": 0.0,
            "shed_rate_per_tier": {}},
        replicas=stats,
        scale_events=[vars(e).copy() for e in
                      (autoscaler.events if autoscaler else [])],
        n_rerouted=n_rerouted,
        ttft=LatencyStats.of([r.ttft for r in completed]),
        decode=LatencyStats.of([r.decode_latency for r in completed]),
        inter_token=LatencyStats.of(
            [r.inter_token_latency for r in completed]),
        kv_transfer=LatencyStats.of(
            [r.kv_transfer_latency for r in completed]),
        n_handoffs=n_handoffs,
        n_handoffs_lost=n_handoffs_lost,
        n_stolen=n_stolen,
        prefix_cache=prefix_totals,
        backend=backend,
    )
