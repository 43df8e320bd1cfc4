"""DriftSched core — the paper's contribution.

Adaptive QoS-aware scheduling under runtime token drift: admission-time
token-budget estimation (Eq. 1-2), runtime job classification (Eq. 3-4),
EMA drift compensation (Eq. 5-6), tenant queues, and the five evaluated
scheduling policies (FIFO, Priority, Weighted, SJF, Aging Priority).
"""

from .admission import AdmissionController, count_tokens
from .drift import DriftSample, DriftTracker, ErrorStats, error_reduction
from .estimator import AdaptiveTokenEstimator, BiasStore, DriftConfig
from .policies import (
    POLICIES,
    AgingPriorityPolicy,
    FifoPolicy,
    PriorityPolicy,
    SchedulingPolicy,
    SjfPolicy,
    WeightedPolicy,
    make_policy,
)
from .queues import FifoQueue, ScoredQueue, TenantQueueManager
from .request import (
    Category,
    Estimate,
    JobClass,
    Request,
    RequestState,
    TenantTier,
)
from .scheduler import DriftScheduler

__all__ = [
    "AdaptiveTokenEstimator", "AdmissionController", "AgingPriorityPolicy",
    "BiasStore", "Category", "DriftConfig", "DriftSample", "DriftScheduler",
    "DriftTracker", "ErrorStats", "Estimate", "FifoPolicy", "FifoQueue",
    "JobClass", "POLICIES", "PriorityPolicy", "Request", "RequestState",
    "SchedulingPolicy", "ScoredQueue", "SjfPolicy", "TenantQueueManager",
    "TenantTier", "WeightedPolicy", "count_tokens", "error_reduction",
    "make_policy",
]
