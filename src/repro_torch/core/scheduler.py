"""The DriftSched scheduling engine (Fig. 1, Sec. II-F/II-J).

Ties together the admission controller (workload analysis), the tenant
queue manager, the active scheduling policy, and the runtime-feedback
loop:

    submit()   -> admission (estimate Eq. 1-2, classify Eq. 3-4, enqueue)
    dispatch() -> policy.select() pops the next request for the worker
    complete() -> drift record + EMA bias update (Eq. 5-6)
    fail()     -> fault-tolerance re-admission (head of tenant queue)

The engine is execution-agnostic: the discrete-event simulator and the
real JAX continuous-batching engine both drive it through this exact
interface, so the scheduling state machine under test is identical in
both. The whole scheduler state (bias store, queues, policy cursor,
admission sequence) is checkpointable for restart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

from .admission import AdmissionController
from .drift import DriftSample, DriftTracker
from .estimator import AdaptiveTokenEstimator, DriftConfig
from .policies import SchedulingPolicy, make_policy
from .queues import TenantQueueManager
from .request import Request, RequestState


class DriftScheduler:
    """QoS-aware scheduler with runtime token-drift compensation."""

    def __init__(self, policy: str | SchedulingPolicy = "fifo",
                 config: Optional[DriftConfig] = None,
                 estimator: Optional[AdaptiveTokenEstimator] = None,
                 max_new_per_step: Optional[int] = None,
                 **policy_kwargs) -> None:
        """``estimator`` may be shared across schedulers: the cluster
        layer hands every replica the same AdaptiveTokenEstimator so
        drift feedback from any replica calibrates them all.

        ``max_new_per_step`` caps how many queued requests
        :meth:`dispatch_step` admits at one iteration boundary of a
        continuous-batching executor (None = fill every free slot).
        Sarathi-style chunked prefill bounds the per-iteration prefill
        *token* budget in the executor; this knob bounds per-iteration
        *admissions*, limiting how much prefill work can pile into one
        iteration in the first place."""
        if estimator is not None and config is not None \
                and estimator.config is not config:
            raise ValueError("pass either a shared estimator or a config, "
                             "not two disagreeing ones")
        self.estimator = estimator or AdaptiveTokenEstimator(
            config or DriftConfig())
        self.config = self.estimator.config
        self.queues = TenantQueueManager()
        self.admission = AdmissionController(self.estimator, self.queues)
        self.policy: SchedulingPolicy = (
            policy if isinstance(policy, SchedulingPolicy)
            else make_policy(policy, **policy_kwargs)
        )
        if max_new_per_step is not None and max_new_per_step < 1:
            raise ValueError(
                f"max_new_per_step must be >= 1 or None, got {max_new_per_step}")
        self.max_new_per_step = max_new_per_step
        self.drift = DriftTracker()
        self.completed: List[Request] = []
        self.dispatched = 0
        # Which serving phase this scheduler's completions observe
        # ("unified", or "decode" on a P/D decode replica — the phase
        # that actually sees the final output length). Used to attribute
        # drift feedback; prefill replicas never call complete().
        self.feedback_phase = "unified"
        # per-phase count of bias-feedback events (at-most-once audit)
        self.phase_feedback_counts: Dict[str, int] = {}

    # --- lifecycle ------------------------------------------------------
    def submit(self, req: Request, now: float) -> Request:
        return self.admission.admit(req, now)

    def dispatch(self, now: float) -> Optional[Request]:
        req = self.policy.select(self.queues, now)
        if req is None:
            return None
        req.dispatch_time = now
        req.state = RequestState.DISPATCHED
        self.dispatched += 1
        return req

    def dispatch_batch(self, now: float, max_n: int) -> List[Request]:
        """Fill up to ``max_n`` slots (batch formation, Sec. III-B)."""
        out: List[Request] = []
        for _ in range(max_n):
            req = self.dispatch(now)
            if req is None:
                break
            out.append(req)
        return out

    def dispatch_step(self, now: float, free_slots: int) -> List[Request]:
        """Slot-granular admission for iteration-level executors: fill
        at most ``free_slots`` freed decode slots, further capped by the
        ``max_new_per_step`` admission knob. Delegates to
        :meth:`dispatch_batch` so the per-request dispatch contract
        (policy selection, state transition, dispatch count) is
        identical on both execution paths."""
        cap = free_slots
        if self.max_new_per_step is not None:
            cap = min(cap, self.max_new_per_step)
        return self.dispatch_batch(now, max(cap, 0))

    def complete(self, req: Request, observed_tokens: int, now: float,
                 phase: Optional[str] = None) -> DriftSample:
        """Runtime feedback (Sec. II-J): record drift, update bias.

        ``phase`` attributes the observation to the serving phase that
        produced it ("unified" single-stage serving, "decode" on a P/D
        decode replica); defaults to this scheduler's
        :attr:`feedback_phase`. Attribution matters for the at-most-once
        contract: in disaggregated serving only the phase that observes
        the final output length (decode) may feed the bias EMA —
        a prefill pass observes no output drift and must stay silent.
        """
        phase = phase or self.feedback_phase
        req.mark_completed(observed_tokens, now)
        sample = self.drift.record(req, now, phase=phase)
        self.estimator.feedback(req.category, float(observed_tokens), now)
        self.phase_feedback_counts[phase] = \
            self.phase_feedback_counts.get(phase, 0) + 1
        self.completed.append(req)
        return sample

    def fail(self, req: Request, now: float) -> Request:
        """Worker failure: re-queue at the head, estimate preserved, no
        bias feedback (at-most-once feedback per completed request)."""
        req.state = RequestState.FAILED
        return self.admission.readmit(req, now)

    # --- introspection ---------------------------------------------------
    @property
    def bias_store(self):
        return self.estimator.bias_store

    def queue_depth(self) -> int:
        return self.queues.depth()

    # --- checkpoint/restore ----------------------------------------------
    def state_dict(self) -> dict:
        return {
            "policy": self.policy.name,
            "policy_state": self.policy.state_dict(),
            "bias": self.bias_store.state_dict(),
            "dispatched": self.dispatched,
            "queued_req_ids": [r.req_id for r in self.queues.all_requests()],
        }

    def load_state_dict(self, state: dict,
                        requests: Optional[Mapping[int, Request]] = None) -> None:
        """Restore scheduler state. ``requests`` maps ``req_id`` to the
        live :class:`Request` objects for any queued-at-checkpoint
        requests (queues hold object references, so the checkpoint only
        records ids); without it a checkpoint with a non-empty queue is
        refused rather than silently dropping the queue."""
        if state.get("policy") != self.policy.name:
            raise ValueError(
                f"checkpoint policy {state.get('policy')!r} != {self.policy.name!r}"
            )
        # validate everything before mutating anything: a caller that
        # catches a restore error must be left with its original state
        queued_ids = list(state.get("queued_req_ids", []))
        if queued_ids and requests is None:
            raise ValueError(
                f"checkpoint has {len(queued_ids)} queued requests; pass "
                "a `requests` registry (req_id -> Request) to restore them")
        missing = [i for i in queued_ids if i not in (requests or {})]
        if missing:
            raise KeyError(f"request registry missing req_ids {missing}")
        self.policy.load_state_dict(state.get("policy_state", {}))
        self.bias_store.load_state_dict(state.get("bias", {}))
        self.dispatched = int(state.get("dispatched", 0))
        # the queue must mirror the checkpoint either way — drop any
        # stale queued requests even when the checkpoint queue is empty
        self.queues.drain()
        for rid in queued_ids:
            req = requests[rid]
            # preserve the original enqueue timestamp: restore must not
            # reset aging/FIFO order
            self.queues.enqueue(req, req.enqueue_time)
