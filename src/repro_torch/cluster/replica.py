"""Replica abstraction for the cluster serving layer.

A *replica* is one serving unit behind the cluster router: a
:class:`~repro.core.scheduler.DriftScheduler` plus an execution backend
(the discrete-event :class:`~repro.serving.simulator.WorkerSimulator`,
or a real :class:`~repro.serving.engine.ServingEngine` via the driver).
The router and autoscaler only see the :class:`Replica` introspection
surface — queued/in-flight estimated-token mass, depth, lifecycle state
— so routing policies are execution-agnostic, exactly like the
scheduler itself. Under the iteration-level step engine
(``ClusterConfig.step_engine``) that surface is iteration-fresh:
in-flight mass drops the moment a slot retires mid-batch, rather than
only at batch drain, so load signals (and the work stealing / autoscale
decisions built on them) track continuous batching honestly.

Token mass is measured in *estimated budget tokens* (Eq. 1): the
cluster layer deliberately reasons in the same calibrated unit the
admission-time estimator produces, so better drift compensation
directly sharpens routing and scaling decisions.

Mass queries walk the live queues (O(depth) per routing decision) the
same way ``ScoredQueue.pop_min_rescored`` re-scores the whole heap:
exact semantics over cached counters, cheap at the experiment scales
here (<= a few thousand queued). Swap in incremental counters at the
enqueue/dispatch/complete hooks if replica counts grow by orders of
magnitude.
"""

from __future__ import annotations

import enum
from typing import List, Optional

from ..core.request import Request
from ..core.scheduler import DriftScheduler


class ReplicaState(enum.Enum):
    """Replica lifecycle (autoscaler + fault-injection driven)."""

    STARTING = "starting"    # provisioned by the autoscaler, not ready yet
    ACTIVE = "active"        # routable
    DRAINING = "draining"    # scale-down: finishes its queue, takes no new work
    FAILED = "failed"        # fault injection: in-flight + queue rerouted
    STOPPED = "stopped"      # drained and removed from the pool


class ReplicaRole(enum.Enum):
    """Which serving phase(s) a replica executes.

    ``UNIFIED`` replicas run prefill + decode in one batch (the paper's
    single-worker protocol, and PR-1 cluster behaviour). Under
    prefill/decode disaggregation, ``PREFILL`` replicas run only prompt
    processing and hand the request off (modeled KV transfer) to a
    ``DECODE`` replica, which runs only token generation — so long
    prefills stop stalling decode batches (arXiv 2602.02987).
    """

    UNIFIED = "unified"
    PREFILL = "prefill"
    DECODE = "decode"

    def can_prefill(self) -> bool:
        """True when new (not-yet-prefilled) requests may land here."""
        return self is not ReplicaRole.DECODE

    def can_decode(self) -> bool:
        """True when prefilled requests may decode here."""
        return self is not ReplicaRole.PREFILL


def _budget(req: Request) -> float:
    """Estimated token budget of a queued request (Eq. 1). Requests are
    always estimated at admission, but be defensive for bare ones."""
    return req.estimate.t_budget if req.estimate is not None else float(
        req.prompt_tokens + req.max_tokens)


class Replica:
    """Base replica: scheduler-backed introspection, no execution.

    All mass quantities are in *estimated budget tokens* (Eq. 1,
    ``Estimate.t_budget`` from the shared estimator); depths are request
    counts; times are seconds.
    """

    def __init__(self, rid: int, scheduler: DriftScheduler,
                 role: ReplicaRole = ReplicaRole.UNIFIED) -> None:
        self.rid = rid
        self.sched = scheduler
        self.state = ReplicaState.ACTIVE
        self.role = role
        self.n_routed = 0            # requests the router sent here
        self.n_rerouted_away = 0     # requests moved off after a failure
        self.n_handoffs_out = 0      # prefills handed off for decode
        self.n_handoffs_in = 0       # decode work received via handoff
        self.n_stolen_away = 0       # queued requests stolen by peers
        self.n_stolen_in = 0         # queued requests stolen from peers

    # --- lifecycle ----------------------------------------------------
    def routable(self) -> bool:
        """True when the router may place new work here (ACTIVE only)."""
        return self.state is ReplicaState.ACTIVE

    # --- load introspection (router / autoscaler signals) -------------
    def queued_requests(self) -> List[Request]:
        """Snapshot of queued (not yet dispatched) requests, in tenant
        queue order."""
        return list(self.sched.queues.all_requests())

    def inflight_requests(self) -> List[Request]:
        """Requests currently executing on this replica's workers
        (empty on the base class: no execution backend)."""
        return []

    def queue_depth(self) -> int:
        """Number of queued requests (count, not token mass)."""
        return self.sched.queue_depth()

    def queued_token_mass(self) -> float:
        """Estimated budget tokens (Eq. 1) waiting in the queues."""
        return sum(_budget(r) for r in self.sched.queues.all_requests())

    def inflight_token_mass(self) -> float:
        """Estimated budget tokens (Eq. 1) currently executing."""
        return sum(_budget(r) for r in self.inflight_requests())

    def prefix_cached_tokens(self, req: Request) -> int:
        """Resident shared-prefix overlap this replica's KV cache holds
        for ``req``, in tokens — THE warmth signal ``prefix_aware``
        routing scores (0 on the base class: no execution backend, no
        cache). Must be a pure probe: called once per routable replica
        per placement, it must not perturb LRU or refcount state."""
        return 0

    def prefix_cache_stats(self) -> dict:
        """Cumulative prefix-cache counters (hits / misses /
        tokens_saved / evicted_pages / resident_pages / invalidations);
        all zero without a cache-backed executor."""
        return {"hits": 0, "misses": 0, "tokens_saved": 0,
                "evicted_pages": 0, "resident_pages": 0,
                "invalidations": 0}

    def token_mass(self) -> float:
        """Total outstanding estimated work (queued + executing)."""
        return self.queued_token_mass() + self.inflight_token_mass()

    def mean_queued_budget(self) -> Optional[float]:
        """Mean estimated budget of queued requests — the homogeneity
        signal drift-aware routing packs against. None when empty."""
        budgets = [_budget(r) for r in self.sched.queues.all_requests()]
        if not budgets:
            return None
        return sum(budgets) / len(budgets)

    def busy_workers(self) -> int:
        """Workers currently executing a batch (utilization signal)."""
        return 1 if self.inflight_requests() else 0

    def alive_workers(self) -> int:
        """Workers not currently failed (utilization denominator)."""
        return 1

    def is_idle(self) -> bool:
        """True when nothing is queued or executing — the precondition
        for this replica to *steal* work from an overloaded peer."""
        return self.queue_depth() == 0 and not self.inflight_requests()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Replica(rid={self.rid}, role={self.role.value}, "
                f"state={self.state.value}, "
                f"depth={self.queue_depth()}, mass={self.token_mass():.0f})")
