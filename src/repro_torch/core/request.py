"""Request model and lifecycle for DriftSched.

A :class:`Request` carries everything the paper's pipeline needs:

* identity + tenant tier + semantic workload category (Sec. II-B/II-D),
* the admission-time estimate fields filled in by the adaptive token
  estimator (Eq. 1-2) and the runtime classifier (Eq. 3-4),
* lifecycle timestamps used by the metrics pipeline (Sec. II-I) to
  separate queueing latency from GPU execution latency,
* the observed output length fed back into the drift compensator
  (Eq. 5-6).
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional


class TenantTier(enum.IntEnum):
    """Service tiers (Sec. II-B). Lower value = higher priority."""

    PREMIUM = 0
    STANDARD = 1
    BATCH = 2

    @property
    def label(self) -> str:
        return self.name.lower()


class Category(enum.Enum):
    """Semantic workload categories (Sec. II-D)."""

    SHORT_QA = "short_qa"
    SUMMARY = "summary"
    TECHNICAL = "technical"
    REPORT = "report"


class JobClass(enum.Enum):
    """Runtime scheduling classes (Eq. 3-4)."""

    SHORT = "short"
    MEDIUM = "medium"
    LONG = "long"


class RequestState(enum.Enum):
    CREATED = "created"
    QUEUED = "queued"
    DISPATCHED = "dispatched"
    EXECUTING = "executing"
    COMPLETED = "completed"
    FAILED = "failed"       # worker failure; will be re-queued
    CANCELLED = "cancelled"


_REQ_IDS = itertools.count()


@dataclass
class Estimate:
    """Admission-time estimate produced by the adaptive token estimator."""

    t_base: float            # baseline workload token estimate (per category)
    bias: float              # B_runtime used for this estimate
    safety: float            # S_tenant
    f_input: float           # prompt-complexity scaling
    est_output_tokens: float  # T_base * B * S * F        (Eq. 2)
    t_budget: float           # T_input - cached + est_out (Eq. 1, with
    #                           the prefix-cache discount; 0 when the
    #                           placement saw no resident overlap)
    job_class: JobClass       # runtime scheduling class   (Eq. 4)
    cached_tokens: int = 0    # resident-prefix tokens priced out of
    #                           T_input at estimation time


@dataclass
class Request:
    tenant: TenantTier
    category: Category
    prompt: str = ""
    prompt_tokens: int = 0           # T_input
    max_tokens: int = 1024           # user-configured generation cap
    # --- shared-prefix identity (radix KV cache) ---
    # The first ``shared_prefix_tokens`` of the prompt are a shared
    # population prefix (tenant system prompt / RAG template) identified
    # by ``prefix_group`` (any hashable; the generator uses
    # (tenant_label, group_idx)). None/0 = no shareable prefix.
    prefix_group: Optional[tuple] = None
    shared_prefix_tokens: int = 0
    # Ground-truth output length. Hidden from the scheduler; consumed by
    # the simulator / engine which "generates" this many tokens (clipped
    # by max_tokens). The real JAX engine ignores it and samples to EOS.
    true_output_tokens: int = 0

    req_id: int = field(default_factory=lambda: next(_REQ_IDS))
    # --- lifecycle timestamps (simulated or wall-clock seconds) ---
    arrival_time: float = 0.0        # submitted to the API gateway
    enqueue_time: float = 0.0        # entered a tenant queue
    dispatch_time: Optional[float] = None   # selected by the policy
    exec_start: Optional[float] = None      # worker began the batch
    exec_end: Optional[float] = None        # worker finished the batch
    completion_time: Optional[float] = None

    state: RequestState = RequestState.CREATED
    estimate: Optional[Estimate] = None
    observed_output_tokens: Optional[int] = None
    worker_id: Optional[int] = None
    retries: int = 0                 # re-dispatches after worker failure

    # --- phase-disaggregated lifecycle (cluster P/D serving) ---
    # All timestamps in the same simulated/wall-clock seconds as above.
    # Unset (None) on the unified path, where one batch covers both
    # phases and ``exec_end`` is the only completion anchor.
    prefill_end: Optional[float] = None     # prefill phase finished (TTFT)
    handoff_time: Optional[float] = None    # KV landed on the decode replica
    prefill_rid: Optional[int] = None       # replica that ran prefill
    decode_rid: Optional[int] = None        # replica that ran decode
    n_steals: int = 0                # times moved by cross-replica stealing
    # --- prefix-cache accounting (set by router / step engine) ---
    # expected: the resident overlap the router observed on the chosen
    # replica at placement (prices the admission budget); realized: the
    # hit actually taken when prefill started (eviction/invalidation
    # may land it below the expectation — drift analyses separate the
    # two, see core.drift.DriftSample).
    expected_cached_tokens: int = 0
    cached_prompt_tokens: int = 0

    # monotone admission sequence number, assigned by the scheduler; used
    # for FIFO / tie-breaking so ordering is fully deterministic.
    seq: int = -1

    # ------------------------------------------------------------------
    @property
    def job_class(self) -> Optional[JobClass]:
        return self.estimate.job_class if self.estimate else None

    @property
    def t_budget(self) -> float:
        if self.estimate is None:
            raise ValueError(f"request {self.req_id} has no estimate yet")
        return self.estimate.t_budget

    @property
    def queue_wait(self) -> Optional[float]:
        if self.dispatch_time is None:
            return None
        return self.dispatch_time - self.arrival_time

    @property
    def e2e_latency(self) -> Optional[float]:
        if self.completion_time is None:
            return None
        return self.completion_time - self.arrival_time

    @property
    def gpu_latency(self) -> Optional[float]:
        """Worker-side execution latency (batch granularity, Sec. IV-J)."""
        if self.exec_end is None or self.exec_start is None:
            return None
        return self.exec_end - self.exec_start

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, seconds since arrival.

        On the P/D-disaggregated path this is the end of the prefill
        phase (the first output token exists once prefill has run). On
        the unified path the cost model is batch-atomic — the first
        token is only observable at batch end — so TTFT degrades to the
        batch completion time. That asymmetry is the honest one: it is
        exactly the TTFT head-of-line damage disaggregation removes.
        """
        end = self.prefill_end if self.prefill_end is not None else self.exec_end
        if end is None:
            return None
        return end - self.arrival_time

    @property
    def decode_latency(self) -> Optional[float]:
        """Decode-phase latency, seconds. On the P/D path: KV arrival
        on the decode replica to completion (decode queueing + decode
        execution). On a unified replica running the step engine: first
        token (``prefill_end``) to completion — pure decode execution.
        None on the legacy atomic unified path, where the batch-atomic
        cost model cannot split the two phases."""
        if self.completion_time is None:
            return None
        anchor = (self.handoff_time if self.handoff_time is not None
                  else self.prefill_end)
        if anchor is None:
            return None
        return self.completion_time - anchor

    @property
    def inter_token_latency(self) -> Optional[float]:
        """Mean inter-token gap, seconds: the decode span divided over
        the ``observed - 1`` gaps after the first token. Includes decode
        queueing on the P/D path (the gap a client actually sees).
        None until completion, on single-token outputs, and on the
        legacy atomic unified path (no first-token anchor)."""
        if self.observed_output_tokens is None \
                or self.observed_output_tokens <= 1:
            return None
        span = self.decode_latency
        if span is None:
            return None
        return span / (self.observed_output_tokens - 1)

    @property
    def kv_transfer_latency(self) -> Optional[float]:
        """Modeled prefill→decode KV-transfer time, seconds (includes
        any re-targeting retries). None outside the P/D path."""
        if self.handoff_time is None or self.prefill_end is None:
            return None
        return self.handoff_time - self.prefill_end

    def mark_completed(self, observed_tokens: int, now: float) -> None:
        self.observed_output_tokens = int(observed_tokens)
        self.completion_time = now
        self.state = RequestState.COMPLETED

    def reset_for_retry(self) -> None:
        """Re-queue after a worker failure (fault tolerance path)."""
        self.retries += 1
        self.dispatch_time = None
        self.exec_start = None
        self.exec_end = None
        self.worker_id = None
        # any prefix-cache hit died with the worker's KV pool; the
        # retry re-probes whatever cache its next replica holds
        self.cached_prompt_tokens = 0
        self.state = RequestState.QUEUED

    def reset_for_reprefill(self) -> None:
        """Re-run the prefill phase from scratch.

        Used when the KV produced by a finished prefill is lost before
        decode completes — the prefill replica died mid-transfer, or the
        decode replica holding the pages failed. The admission estimate
        is deliberately kept (at-most-once feedback: nothing was
        observed yet, so nothing may be re-priced)."""
        self.reset_for_retry()
        self.prefill_end = None
        self.handoff_time = None
        self.prefill_rid = None
        self.decode_rid = None
