"""Cluster serving layer: many replicas behind one calibrated front end.

The paper validates DriftSched on a single worker; this package scales
the same state machine out to N replicas without changing it:

* :mod:`replica`    — the execution-agnostic replica surface (state,
  estimated-token mass, worker signals) routing and scaling reason over;
* :mod:`router`     — ``ClusterRouter`` with six pluggable policies
  (``round_robin`` / ``least_loaded`` / ``drift_aware`` /
  ``tenant_affinity`` / ``prefix_aware`` / ``pd_disaggregated``), all
  priced by the *shared* ``AdaptiveTokenEstimator``, plus the
  cross-replica work-stealing protocol;
* :mod:`admission`  — ``GlobalAdmission``: per-tenant token-bucket rate
  limits in estimated budget tokens, cluster-depth backpressure, and
  per-tier shed accounting;
* :mod:`autoscaler` — utilization + queue-mass elastic scaling with
  hysteresis, cooldowns, and cold-start delays; ``RoleAutoscaler``
  scales prefill and decode pools separately against a ratio target;
* :mod:`simulator`  — ``ClusterSimulator``: N per-replica
  ``WorkerSimulator`` instances composed under one event heap and one
  seed, with replica-failure rerouting; under ``pd_disaggregated``
  routing the request lifecycle becomes a two-stage pipeline (prefill
  replica → modeled KV transfer → decode replica);
* :mod:`driver`     — the same router/admission front end over real
  ``ServingEngine`` instances (oracle-EOS caveat applies, see the
  module docstring);
* :mod:`metrics`    — cluster-level aggregation (RunMetrics + shed
  rates, per-replica utilization, scale events).
"""

from .admission import (AdmissionConfig, GlobalAdmission, TokenBucket,
                        SHED_BACKPRESSURE, SHED_NO_REPLICA, SHED_RATE_LIMIT)
from .autoscaler import (Autoscaler, AutoscalerConfig, RoleAutoscaler,
                         RoleAutoscalerConfig, ScaleEvent)
from .metrics import ClusterMetrics, ReplicaStats, summarize_cluster
from .replica import Replica, ReplicaRole, ReplicaState
from .router import (ClusterRouter, DriftAwareRouting, LeastLoadedRouting,
                     PDDisaggregatedRouting, PrefixAwareRouting,
                     ROUTING_POLICIES, RoundRobinRouting, RoutingPolicy,
                     StealPlan, TenantAffinityRouting, make_routing_policy)
from .simulator import ClusterConfig, ClusterSimulator, Handoff, SimReplica

__all__ = [
    "AdmissionConfig", "Autoscaler", "AutoscalerConfig", "ClusterConfig",
    "ClusterMetrics", "ClusterRouter", "ClusterSimulator",
    "DriftAwareRouting", "GlobalAdmission", "Handoff",
    "LeastLoadedRouting", "PDDisaggregatedRouting", "PrefixAwareRouting",
    "ROUTING_POLICIES",
    "Replica", "ReplicaRole", "ReplicaState", "ReplicaStats",
    "RoleAutoscaler", "RoleAutoscalerConfig", "RoundRobinRouting",
    "RoutingPolicy", "SHED_BACKPRESSURE", "SHED_NO_REPLICA",
    "SHED_RATE_LIMIT", "ScaleEvent", "SimReplica", "StealPlan",
    "TenantAffinityRouting", "TokenBucket", "make_routing_policy",
    "summarize_cluster",
]
