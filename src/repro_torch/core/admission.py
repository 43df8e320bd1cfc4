"""API-gateway admission path (Sec. II-A, Fig. 1).

The paper fronts the system with a FastAPI gateway; here the gateway is
an in-process component (the serving engine and simulator call it
directly) with the identical pipeline:

    raw request -> workload analysis (estimate + classify, Eq. 1-4)
                -> tenant queue assignment (Sec. II-E)

Prompt length is measured in whitespace-delimited units — the same
computationally-inexpensive proxy the paper uses for output length
(Sec. II-C1). ``count_tokens`` is the single place this proxy lives so
swapping in a real tokenizer (the paper's stated future work) is a
one-line change.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional

from .estimator import AdaptiveTokenEstimator
from .queues import TenantQueueManager
from .request import Category, Request, RequestState, TenantTier


def count_tokens(text: str) -> int:
    """Whitespace-delimited word count (paper Sec. II-C1 proxy)."""
    return len(text.split())


@dataclass
class AdmissionRecord:
    """Per-admission log row (metrics pipeline, Sec. II-I)."""

    req_id: int
    time: float
    tenant: str
    category: str
    job_class: str
    t_budget: float
    bias_used: float


class AdmissionController:
    """Applies the workload-analysis layer and routes into tenant queues."""

    def __init__(self, estimator: AdaptiveTokenEstimator,
                 queues: TenantQueueManager) -> None:
        self.estimator = estimator
        self.queues = queues
        self._seq = itertools.count()
        self.log: List[AdmissionRecord] = []

    def admit(self, req: Request, now: float) -> Request:
        if req.prompt_tokens <= 0 and req.prompt:
            req.prompt_tokens = count_tokens(req.prompt)
        req.arrival_time = now
        req.seq = next(self._seq)
        # expected_cached_tokens is the resident-prefix overlap the
        # router observed on this replica at placement (0 without a
        # prefix cache): the budget prices only the uncached suffix
        req.estimate = self.estimator.estimate(
            req.category, req.tenant, req.prompt_tokens,
            cached_tokens=req.expected_cached_tokens,
        )
        self.queues.enqueue(req, now)
        self.log.append(AdmissionRecord(
            req_id=req.req_id, time=now, tenant=req.tenant.label,
            category=req.category.value, job_class=req.estimate.job_class.value,
            t_budget=req.estimate.t_budget, bias_used=req.estimate.bias,
        ))
        return req

    def readmit(self, req: Request, now: float) -> Request:
        """Fault-tolerance path: a request whose worker died is re-queued
        at the head of its tenant queue. The original estimate is kept —
        re-admission must be idempotent w.r.t. the learned bias (no
        double feedback; feedback only fires on completion)."""
        req.reset_for_retry()
        self.queues.enqueue(req, now, front=True)
        return req
