"""Vectorized array-based simulator core (million-request sweeps).

Two fast executors, both locked to the object engine
(:class:`repro.serving.simulator.WorkerSimulator`) by the differential
parity suite (``tests/test_vector_parity.py``):

* :class:`VectorWorkerSimulator` — the **standalone** flat-array engine
  behind ``SimConfig.backend="vector"``. Every per-request field (slot
  tables, token ledgers, arrival/prefill/decode state, tenant/class
  ids, lifecycle stamps) lives in a flat numpy column of
  :class:`VectorState`; admission, queueing, dispatch, chunked-prefill
  budget sharing, continuous joins, retirement, paged-KV page
  accounting and prefix-cache discounts are array/index operations
  instead of per-request Python objects. Consecutive pure-decode
  iterations of a batch are additionally *epoch-batched*: one heap
  event advances ``k`` iterations at once whenever no other event can
  observe or perturb the batch in between (see ``_schedule_step``).
  For ``N <= a few hundred`` with a matched seed it reproduces the
  object engine's completion order, TTFT/e2e stamps, token ledgers,
  prefix hit/miss counters, depth history and ``RunMetrics``
  **bit-for-bit** (the ``aging`` policy is order-equivalent in real
  arithmetic but not bit-locked — its selection key is algebraically
  shifted; see ``_VectorQueues``).

* :class:`StepVectorizedWorkerSimulator` — the **composed** (cluster)
  fast path: a drop-in :class:`WorkerSimulator` subclass that keeps
  the real :class:`DriftScheduler` and Request objects (so routing,
  stealing, reroute and cluster metrics work unchanged) but
  epoch-batches full pure-decode batches when the cost model is
  jitter-free, with exact mid-epoch truncation on worker failure.
  Requires an external event sink (the cluster heap).

Exactness contract (what is and is not bit-identical) is documented in
``docs/architecture.md`` §"Vectorized core & differential oracle".
Known, deliberate divergences of the standalone engine: no lifecycle
trace emission, and ``HeartbeatMonitor``/``StragglerDetector`` internal
state is not advanced on epoch-interior iterations (both are
unobservable in any reported metric; straggler *mitigation* disables
epochs entirely, so mitigation decisions never see stale state).

Determinism: one ``random.Random(seed)`` consumed in the identical
order as the object engine (epoch loops draw per-iteration jitter from
the same stream; a draw made while probing an epoch boundary is carried
into the next scheduled step, never discarded).
"""

from __future__ import annotations

import bisect
import heapq
import itertools
import math
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.estimator import DriftConfig
from ..core.request import Category, JobClass, TenantTier
from ..distributed.fault_tolerance import HeartbeatMonitor, StragglerDetector
from ..workload.generator import (ArrivalPlan, CATEGORY_ORDER, TIER_ORDER,
                                  VectorPlan)
from .cost_model import CostModel, L4_QWEN_1_8B
from .kv_cache import (PagedAllocator, PrefixTree, pages_needed_array,
                       prefix_page_key)
from .metrics import RunMetrics, summarize_run_arrays
from .simulator import (GPU_MEM_DYNAMIC_GB, GPU_MEM_PLATEAU_GB,
                        KV_MAX_CONTEXT_TOKENS, KV_PAGE_TOKENS, SimConfig,
                        TelemetrySample, WorkerSimulator, WorkerState,
                        _pages_needed)

__all__ = ["VectorState", "VectorWorkerSimulator",
           "StepVectorizedWorkerSimulator"]

# Request lifecycle codes (mirror RequestState declaration order).
S_CREATED, S_QUEUED, S_DISPATCHED, S_EXECUTING, S_COMPLETED, S_FAILED = \
    range(6)

_JOB_CLASS_ORDER: Tuple[JobClass, ...] = tuple(JobClass)


class _Col:
    """Append-only numpy column with amortised doubling (compact
    history storage: depth samples, bias trajectory, telemetry)."""

    __slots__ = ("_a", "n")

    def __init__(self, dtype, cap: int = 1024) -> None:
        self._a = np.empty(cap, dtype=dtype)
        self.n = 0

    def append(self, v) -> None:
        if self.n == self._a.shape[0]:
            self._a = np.concatenate([self._a, np.empty_like(self._a)])
        self._a[self.n] = v
        self.n += 1

    def extend(self, vs) -> None:
        m = len(vs)
        while self.n + m > self._a.shape[0]:
            self._a = np.concatenate([self._a, np.empty_like(self._a)])
        self._a[self.n:self.n + m] = vs
        self.n += m

    def view(self) -> np.ndarray:
        return self._a[:self.n]


class VectorState:
    """Flat per-request state columns for one simulation run.

    Row ``i`` is request ``i`` of the :class:`VectorPlan` (arrival
    order within each burst). Lifecycle stamps are float64 with NaN as
    the object world's ``None``."""

    def __init__(self, plan: VectorPlan) -> None:
        n = len(plan)
        self.n = n
        self.plan = plan
        # --- identity (borrowed from the plan, never mutated) ---
        self.req_id = plan.req_id
        self.tenant = plan.tenant.astype(np.int64)
        self.category = plan.category.astype(np.int64)
        self.prompt_tokens = plan.prompt_tokens.astype(np.int64)
        self.max_tokens = plan.max_tokens.astype(np.int64)
        self.true_output_tokens = plan.true_output_tokens.astype(np.int64)
        self.shared_prefix_tokens = plan.shared_prefix_tokens.astype(np.int64)
        self.prefix_gid = plan.prefix_gid.astype(np.int64)
        # --- lifecycle stamps (NaN = unset) ---
        self.arrival = np.full(n, np.nan)
        self.enqueue = np.full(n, np.nan)
        self.dispatch = np.full(n, np.nan)
        self.exec_start = np.full(n, np.nan)
        self.exec_end = np.full(n, np.nan)
        self.completion = np.full(n, np.nan)
        self.prefill_end = np.full(n, np.nan)
        self.observed = np.full(n, -1, dtype=np.int64)
        self.state = np.full(n, S_CREATED, dtype=np.int8)
        self.seq = np.full(n, -1, dtype=np.int64)
        self.retries = np.zeros(n, dtype=np.int32)
        self.worker = np.full(n, -1, dtype=np.int32)
        # --- admission estimate (Eq. 1-4) ---
        self.t_budget = np.full(n, np.nan)
        self.est_out = np.full(n, np.nan)
        self.bias_used = np.full(n, np.nan)
        self.f_input = np.full(n, np.nan)
        self.job_class = np.full(n, -1, dtype=np.int8)
        # --- execution-side accounting ---
        # token ledger legs ([prefill processed, decode emitted]) and
        # the prefix-cache credit; `has_ledger` mirrors dict membership
        # in the object engine (entries pop on worker failure).
        self.led_prefill = np.zeros(n, dtype=np.int64)
        self.led_decode = np.zeros(n, dtype=np.int64)
        self.prefix_credit = np.zeros(n, dtype=np.int64)
        self.has_ledger = np.zeros(n, dtype=bool)
        self.cached_prompt_tokens = np.zeros(n, dtype=np.int64)
        # enqueue generation for lazy heap invalidation (sjf/aging)
        self.ticket = np.zeros(n, dtype=np.int64)

    # -- dict views (parity/introspection; do not call at 10^6 scale) --
    def token_ledger(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for i in np.nonzero(self.has_ledger)[0]:
            out[int(self.req_id[i])] = [int(self.led_prefill[i]),
                                        int(self.led_decode[i])]
        return out

    def prefix_ledger(self) -> Dict[int, int]:
        return {int(self.req_id[i]): int(self.prefix_credit[i])
                for i in np.nonzero(self.has_ledger)[0]}


class _VectorBias:
    """Per-category EMA bias store on scalars (exact mirror of
    :class:`repro.core.estimator.BiasStore` arithmetic, no locks —
    the vector engine is single-threaded by construction)."""

    def __init__(self, cfg: DriftConfig) -> None:
        self.cfg = cfg
        self.t_base = [float(cfg.base_estimates[c]) for c in CATEGORY_ORDER]
        self.bias = [float(cfg.bias_init)] * len(CATEGORY_ORDER)
        self.updates = [0] * len(CATEGORY_ORDER)
        self.step = 0
        # compact Fig.-5 trajectory: (step implicit), time, cat, bias
        self.hist_time = _Col(np.float64)
        self.hist_cat = _Col(np.int8)
        self.hist_bias = _Col(np.float64)

    def get(self, cat: int) -> float:
        if not self.cfg.bias_enabled:
            return self.cfg.bias_init
        return self.bias[cat]

    def update(self, cat: int, t_actual: float, now: float) -> float:
        cfg = self.cfg
        lo, hi = cfg.bias_clip
        b_measured = min(max(t_actual / self.t_base[cat], lo), hi)
        if cfg.bias_enabled:
            b_old = self.bias[cat]
            b_new = (1.0 - cfg.ema_alpha) * b_old + cfg.ema_alpha * b_measured
            self.bias[cat] = b_new
        else:
            b_new = self.bias[cat]
        self.updates[cat] += 1
        self.step += 1
        self.hist_time.append(now)
        self.hist_cat.append(cat)
        self.hist_bias.append(b_new)
        return b_new

    def update_many(self, cats: List[int], t_actuals, now: float) -> None:
        """Batch form of :meth:`update`: one call per retired slot in
        join order, identical float sequence (the EMA recurrence is
        inherently sequential; only the history appends are bulked)."""
        cfg = self.cfg
        lo, hi = cfg.bias_clip
        enabled = cfg.bias_enabled
        alpha = cfg.ema_alpha
        one_m = 1.0 - alpha
        bias = self.bias
        t_base = self.t_base
        updates = self.updates
        out = []
        for cat, t_actual in zip(cats, t_actuals):
            b_measured = min(max(t_actual / t_base[cat], lo), hi)
            if enabled:
                b_new = one_m * bias[cat] + alpha * b_measured
                bias[cat] = b_new
            else:
                b_new = bias[cat]
            updates[cat] += 1
            out.append(b_new)
        n = len(out)
        self.step += n
        self.hist_time.extend([now] * n)
        self.hist_cat.extend(cats)
        self.hist_bias.extend(out)

    def snapshot(self) -> Dict[str, float]:
        return {c.value: self.bias[i] for i, c in enumerate(CATEGORY_ORDER)}

    def update_counts(self) -> Dict[str, int]:
        return {c.value: self.updates[i]
                for i, c in enumerate(CATEGORY_ORDER)}


_EXACT_POLICIES = ("fifo", "priority", "sjf", "weighted")
_VECTOR_POLICIES = _EXACT_POLICIES + ("aging",)


class VectorSched:
    """Admission + tenant queues + policy selection over
    :class:`VectorState` rows.

    Arithmetic mirrors :class:`AdaptiveTokenEstimator` /
    :class:`DriftScheduler` operation-for-operation (the f_input ratio
    is computed before the log2, the EMA in the object's association
    order) so estimates, job classes and therefore SJF order are
    bit-identical.

    Queue structures per policy:

    * ``fifo`` / ``priority`` / ``weighted`` — one deque per tenant
      tier (entries are row indices; failure re-queues appendleft).
      Head-min / pattern-cursor selection mirrors the object policies.
    * ``sjf`` — a lazy min-heap keyed ``(t_budget, seq)``; entries are
      invalidated by a per-row enqueue ticket instead of the object's
      O(depth) scan-remove. ``seq`` is unique, so heap order equals the
      object's scan-min order exactly.
    * ``aging`` — a lazy heap on the time-shifted key ``tier*threshold
      + rate*enqueue_time`` (the object evaluates ``tier*threshold -
      rate*(now - enqueue_time)``; the two orders agree in real
      arithmetic but may diverge in the last float ulp, so aging is
      vector-supported but excluded from the bit-exact parity arms).
    """

    def __init__(self, state: VectorState, policy: str = "fifo",
                 drift_config: Optional[DriftConfig] = None,
                 max_new_per_step: Optional[int] = None, *,
                 depth_stride: int = 1,
                 aging_threshold: float = 240.0,
                 aging_rate: float = 1.0) -> None:
        if policy not in _VECTOR_POLICIES:
            raise ValueError(
                f"backend='vector' supports policies {_VECTOR_POLICIES}, "
                f"got {policy!r}")
        if max_new_per_step is not None and max_new_per_step < 1:
            raise ValueError(
                f"max_new_per_step must be >= 1 or None, got {max_new_per_step}")
        self.state = state
        self.policy = policy
        self.config = drift_config or DriftConfig()
        self.max_new_per_step = max_new_per_step
        self.bias = _VectorBias(self.config)
        self._safety = [float(self.config.tenant_safety[t])
                        for t in TIER_ORDER]
        self._aging_thr = float(aging_threshold)
        self._aging_rate = float(aging_rate)
        self._seq = 0
        self.dispatched = 0
        self.n_completed = 0
        self.completed_order = _Col(np.int64)
        # per-tier queued counts + containers
        self._depth = [0, 0, 0]
        self._tier_q: List = [None, None, None]
        if policy in ("fifo", "priority", "weighted"):
            from collections import deque
            self._tier_q = [deque(), deque(), deque()]
        self._heap: List[tuple] = []
        self._fin_cache: Dict[int, float] = {}
        self._wpattern = [0] * 5 + [1] * 3 + [2] * 2
        self._wcursor = 0
        # depth history (queues.record_depth mirror), optionally strided
        self.depth_stride = max(int(depth_stride), 1)
        self._depth_calls = 0
        self.d_time = _Col(np.float64)
        self.d_p = _Col(np.int32)
        self.d_s = _Col(np.int32)
        self.d_b = _Col(np.int32)
        self.phase_feedback = 0

    # --- admission (Eq. 1-4, op-order faithful) -----------------------
    def submit(self, i: int, now: float) -> None:
        st, cfg = self.state, self.config
        st.arrival[i] = now
        st.seq[i] = self._seq
        self._seq += 1
        cat = int(st.category[i])
        p = int(st.prompt_tokens[i])
        bias = self.bias.get(cat)
        safety = self._safety[int(st.tenant[i])]
        # f_input depends only on the (heavily repeated) prompt length:
        # memoise the exact float the inline computation produces
        f_in = self._fin_cache.get(p)
        if f_in is None:
            ratio = max(float(p), 1.0) / cfg.f_input_ref_tokens
            raw = 1.0 + cfg.f_input_log_slope * math.log2(ratio)
            lo, hi = cfg.f_input_clip
            f_in = min(max(raw, lo), hi)
            self._fin_cache[p] = f_in
        est_out = self.bias.t_base[cat] * bias * safety * f_in
        # standalone arrivals carry no expected cached tokens (the
        # router-side hint is a cluster concept): cached == 0 here.
        t_budget = float(p - 0) + est_out
        st.bias_used[i] = bias
        st.f_input[i] = f_in
        st.est_out[i] = est_out
        st.t_budget[i] = t_budget
        if t_budget <= cfg.short_threshold:
            st.job_class[i] = 0
        elif t_budget <= cfg.long_threshold:
            st.job_class[i] = 1
        else:
            st.job_class[i] = 2
        self._enqueue(i, now)

    def _enqueue(self, i: int, now: float, front: bool = False) -> None:
        st = self.state
        tier = int(st.tenant[i])
        st.enqueue[i] = now
        st.state[i] = S_QUEUED
        st.ticket[i] += 1
        self._depth[tier] += 1
        if self.policy == "sjf":
            heapq.heappush(self._heap, (float(st.t_budget[i]),
                                        int(st.seq[i]), i,
                                        int(st.ticket[i])))
        elif self.policy == "aging":
            key = tier * self._aging_thr + self._aging_rate * now
            heapq.heappush(self._heap, (key, int(st.seq[i]), i,
                                        int(st.ticket[i])))
        else:
            dq = self._tier_q[tier]
            if front:
                dq.appendleft(i)
            else:
                dq.append(i)

    # --- selection ----------------------------------------------------
    def _pop_heads(self, keyfn) -> Optional[int]:
        best = None
        best_key = None
        best_tier = -1
        for tier in range(3):
            dq = self._tier_q[tier]
            if not dq:
                continue
            k = keyfn(dq[0], tier)
            if best is None or k < best_key:
                best, best_key, best_tier = dq[0], k, tier
        if best is None:
            return None
        return self._tier_q[best_tier].popleft()

    def _pop_lazy(self) -> Optional[int]:
        st = self.state
        while self._heap:
            _, _, i, ticket = self._heap[0]
            heapq.heappop(self._heap)
            if st.state[i] == S_QUEUED and st.ticket[i] == ticket:
                return i
        return None

    def _pop_weighted(self) -> Optional[int]:
        if sum(self._depth) == 0:
            return None
        n = len(self._wpattern)
        for step in range(n):
            tier = self._wpattern[(self._wcursor + step) % n]
            dq = self._tier_q[tier]
            if dq:
                self._wcursor = (self._wcursor + step + 1) % n
                return dq.popleft()
        return None

    def _pop_fifo(self) -> Optional[int]:
        # _pop_heads specialised to the fifo key (smallest admission
        # seq across tier heads) — no lambda/tuple per probe; this is
        # the hottest selection path in big sweeps
        seq = self.state.seq
        best_tier = -1
        best_key = None
        for tier in range(3):
            dq = self._tier_q[tier]
            if dq:
                k = seq[dq[0]]
                if best_tier < 0 or k < best_key:
                    best_key, best_tier = k, tier
        if best_tier < 0:
            return None
        return self._tier_q[best_tier].popleft()

    def _select(self, now: float) -> Optional[int]:
        st = self.state
        if self.policy == "fifo":
            return self._pop_fifo()
        if self.policy == "priority":
            return self._pop_heads(
                lambda i, tier: (tier * 1e12 + float(st.arrival[i]),
                                 int(st.seq[i])))
        if self.policy == "weighted":
            return self._pop_weighted()
        return self._pop_lazy()          # sjf / aging

    def dispatch(self, now: float) -> Optional[int]:
        i = self._select(now)
        if i is None:
            return None
        st = self.state
        self._depth[int(st.tenant[i])] -= 1
        st.dispatch[i] = now
        st.state[i] = S_DISPATCHED
        self.dispatched += 1
        return i

    def dispatch_step(self, now: float, free_slots: int) -> List[int]:
        cap = free_slots
        if self.max_new_per_step is not None:
            cap = min(cap, self.max_new_per_step)
        out: List[int] = []
        for _ in range(max(cap, 0)):
            i = self.dispatch(now)
            if i is None:
                break
            out.append(i)
        return out

    # --- feedback / failure -------------------------------------------
    def complete(self, i: int, observed: int, now: float) -> None:
        st = self.state
        st.observed[i] = observed
        st.completion[i] = now
        st.state[i] = S_COMPLETED
        self.bias.update(int(st.category[i]), float(observed), now)
        self.phase_feedback += 1
        self.completed_order.append(i)
        self.n_completed += 1

    def complete_many(self, rows: List[int], observed: List[int],
                      now: float) -> int:
        """Batch form of :meth:`complete` for a drained batch's held
        retirements: same end state, same EMA/feedback order (join
        order), stamps applied as one masked write."""
        st = self.state
        ridx = np.asarray(rows, dtype=np.int64)
        st.observed[ridx] = observed
        st.completion[ridx] = now
        st.state[ridx] = S_COMPLETED
        self.bias.update_many(st.category[ridx].tolist(), observed, now)
        n = len(rows)
        self.phase_feedback += n
        self.completed_order.extend(rows)
        self.n_completed += n
        return n

    def fail(self, i: int, now: float) -> None:
        """Worker failure: re-queue at the head, estimate preserved, no
        bias feedback (mirrors ``reset_for_retry`` + readmit)."""
        st = self.state
        st.retries[i] += 1
        st.dispatch[i] = np.nan
        st.exec_start[i] = np.nan
        st.exec_end[i] = np.nan
        st.worker[i] = -1
        st.cached_prompt_tokens[i] = 0
        self._enqueue(i, now, front=True)

    # --- introspection ------------------------------------------------
    def queue_depth(self) -> int:
        return sum(self._depth)

    def depths(self) -> Dict[TenantTier, int]:
        return {t: self._depth[int(t)] for t in TIER_ORDER}

    def record_depth(self, now: float) -> None:
        self._depth_calls += 1
        if self.depth_stride > 1 and (self._depth_calls % self.depth_stride):
            return
        self.d_time.append(now)
        self.d_p.append(self._depth[0])
        self.d_s.append(self._depth[1])
        self.d_b.append(self._depth[2])

    def depth_history(self) -> List[Tuple[float, int, int, int]]:
        return list(zip(self.d_time.view().tolist(),
                        self.d_p.view().tolist(),
                        self.d_s.view().tolist(),
                        self.d_b.view().tolist()))


class _VectorBatch:
    """Array-form :class:`RunningBatch`: one row per occupied slot, in
    join order. ``held`` are retired-but-held slots (non-continuous
    joins drain everyone at batch end)."""

    __slots__ = ("idx", "pr", "tgt", "done", "cached", "nodes", "keys",
                 "held", "gen", "pending", "epoch", "ek")

    def __init__(self, gen: int) -> None:
        self.idx = np.empty(0, dtype=np.int64)   # VectorState row ids
        self.pr = np.empty(0, dtype=np.int64)    # prefill remaining
        self.tgt = np.empty(0, dtype=np.int64)   # decode target
        self.done = np.empty(0, dtype=np.int64)  # decode emitted
        self.cached = np.empty(0, dtype=np.int64)
        self.nodes: List = []                    # locked PrefixNodes
        self.keys: List[tuple] = []              # prefix page keys
        self.held: List[tuple] = []              # (row, done, node, cached)
        self.gen = gen
        self.pending = None                      # (take, emits) arrays
        self.epoch = None                        # sorted boundary times
        self.ek = 0                              # epoch steps per slot
        #                                          (int, or int64 array
        #                                          when a drain epoch
        #                                          crosses retirements)


class VectorWorkerSimulator:
    """Standalone flat-array replica simulator (``backend="vector"``).

    Drop-in for a standalone step-engine :class:`WorkerSimulator` run:
    same :class:`SimConfig`, same cost model, same seed discipline, and
    (for the bit-exact policies) the same event trajectory — but
    per-request state lives in :class:`VectorState` columns, iteration
    boundaries are array updates, and runs of pure-decode iterations
    are collapsed into epochs. Raises rather than approximating on the
    features the array core does not model (atomic batches, hedging,
    P/D phases, external sinks): those stay on the object engine.
    """

    def __init__(self, plan, config: Optional[SimConfig] = None,
                 cost_model: Optional[CostModel] = None, *,
                 policy: str = "fifo",
                 drift_config: Optional[DriftConfig] = None,
                 max_new_per_step: Optional[int] = None,
                 rng: Optional[random.Random] = None,
                 aging_threshold: float = 240.0,
                 aging_rate: float = 1.0) -> None:
        self.cfg = config or SimConfig()
        cfg = self.cfg
        if not cfg.step_engine:
            raise ValueError(
                "backend='vector' implements only the iteration-level "
                "step engine; set SimConfig(step_engine=True) or use "
                "the object backend for atomic batches")
        if cfg.hedge:
            raise ValueError("hedging is an object-engine feature "
                             "(and is incompatible with step_engine)")
        if cfg.phase != "unified":
            raise ValueError(
                "backend='vector' serves the unified phase only; P/D "
                "disaggregation needs the object engine")
        if cfg.chunk_prefill_tokens is not None \
                and cfg.chunk_prefill_tokens < 1:
            raise ValueError(
                f"chunk_prefill_tokens must be >= 1 or None, "
                f"got {cfg.chunk_prefill_tokens}")
        if plan is None:
            raise ValueError("VectorWorkerSimulator needs a plan")
        if isinstance(plan, ArrivalPlan):
            plan = VectorPlan.from_plan(plan)
        self.plan: VectorPlan = plan
        self.state = VectorState(plan)
        self.sched = VectorSched(self.state, policy, drift_config,
                                 max_new_per_step,
                                 depth_stride=cfg.depth_stride,
                                 aging_threshold=aging_threshold,
                                 aging_rate=aging_rate)
        self.cost = cost_model or L4_QWEN_1_8B
        self.rng = rng or random.Random(cfg.seed)
        self.workers = [WorkerState() for _ in range(cfg.n_workers)]
        self.heartbeats = HeartbeatMonitor(timeout=10.0)
        self.stragglers = StragglerDetector()
        self.telemetry: List[TelemetrySample] = []
        self.n_failed_dispatches = 0
        self.n_steps = 0
        self.n_joins = 0
        self.n_epochs = 0            # epoch events (each covers >=1 steps)
        self.phase_boundary: float = 0.0
        self.prefix_tree: Optional[PrefixTree] = None
        if cfg.prefix_cache:
            self.prefix_tree = PrefixTree(PagedAllocator(
                n_pages=cfg.prefix_cache_pages,
                page_size=cfg.prefix_page_tokens, pages_per_seq=1))
        self.n_prefix_hits = 0
        self.n_prefix_misses = 0
        self.prefix_tokens_saved = 0
        self.n_cache_invalidations = 0
        self._events: List[tuple] = []
        self._eseq = itertools.count()
        self._gen = itertools.count(1)
        self._pending_batch_start: Dict[int, bool] = {}
        self._batches: Dict[int, _VectorBatch] = {}
        self._carry_jitter: Dict[int, float] = {}
        self._key_cache: Dict[Tuple[int, int], tuple] = {}
        # times at which worker/queue state can change out-of-band
        # (failures, straggler onset, repairs): epochs never cross them
        self._disrupts: List[float] = sorted(cfg.fail_times)
        if cfg.straggler_worker is not None:
            bisect.insort(self._disrupts, cfg.straggler_after)
        # arrival-array cursor state (installed by run())
        self._arr_t: Optional[np.ndarray] = None
        self._arr_es: Optional[np.ndarray] = None
        self._ap = 0
        self._arr_ready = 0
        self._stress_released = False

    # --- object-engine-compatible introspection -----------------------
    @property
    def token_ledger(self) -> Dict[int, List[int]]:
        return self.state.token_ledger()

    @property
    def prefix_ledger(self) -> Dict[int, int]:
        return self.state.prefix_ledger()

    def prefix_cache_stats(self) -> Dict[str, int]:
        return {
            "hits": self.n_prefix_hits,
            "misses": self.n_prefix_misses,
            "tokens_saved": self.prefix_tokens_saved,
            "evicted_pages": (self.prefix_tree.n_evicted_pages
                              if self.prefix_tree else 0),
            "resident_pages": (self.prefix_tree.total_pages()
                               if self.prefix_tree else 0),
            "invalidations": self.n_cache_invalidations,
        }

    def n_busy_workers(self) -> int:
        return sum(1 for w in self.workers if w.alive and not w.idle)

    def n_alive_workers(self) -> int:
        return sum(1 for w in self.workers if w.alive)

    # --- event plumbing ------------------------------------------------
    def _push(self, t: float, kind: str, payload=None) -> None:
        heapq.heappush(self._events, (t, next(self._eseq), kind, payload))

    def _eligible_workers(self, now: float) -> List[int]:
        out = []
        for i, w in enumerate(self.workers):
            if not (w.alive and w.idle):
                continue
            if (self.cfg.mitigate_stragglers
                    and i in self.stragglers.stragglers()):
                continue
            out.append(i)
        return out

    def _try_dispatch(self, now: float) -> None:
        if self.sched.queue_depth() == 0:
            return
        for wid in self._eligible_workers(now):
            if self._pending_batch_start.get(wid):
                continue
            self._pending_batch_start[wid] = True
            self._push(now + self.cfg.batch_wait, "batch_start", wid)

    # --- slot creation --------------------------------------------------
    def _prefix_key(self, i: int) -> tuple:
        gid = int(self.state.prefix_gid[i])
        if gid < 0 or self.prefix_tree is None:
            return ()
        shared = int(self.state.shared_prefix_tokens[i])
        ck = (gid, shared)
        key = self._key_cache.get(ck)
        if key is None:
            key = prefix_page_key(self.plan.group_table[gid], shared,
                                  self.cfg.prefix_page_tokens)
            self._key_cache[ck] = key
        return key

    def _make_slot(self, i: int, now: float) -> Tuple[int, int, int,
                                                      object, tuple]:
        """Returns ``(prefill_remaining, target, cached, node, key)``
        for row ``i`` joining a batch (mirrors ``WorkerSimulator.
        _make_slot`` minus P/D handoff, which the vector core refuses
        at construction)."""
        st = self.state
        prefill = int(st.prompt_tokens[i])
        target = int(min(st.true_output_tokens[i], st.max_tokens[i]))
        cached = 0
        node = None
        key = ()
        if self.prefix_tree is not None and prefill > 0:
            key = self._prefix_key(i)
            if key:
                n0, n_pages = self.prefix_tree.match(key, now)
                c = min(n_pages * self.cfg.prefix_page_tokens, prefill)
                if c > 0:
                    self.prefix_tree.lock(n0)
                    node = n0
                    cached = c
                    self.n_prefix_hits += 1
                    self.prefix_tokens_saved += c
                else:
                    self.n_prefix_misses += 1
        st.cached_prompt_tokens[i] = cached
        st.led_prefill[i] = 0
        st.led_decode[i] = 0
        st.prefix_credit[i] = cached
        st.has_ledger[i] = True
        return prefill - cached, target, cached, node, key

    def _start_batch(self, wid: int, now: float) -> None:
        w = self.workers[wid]
        if not (w.alive and w.idle):
            return
        rows = self.sched.dispatch_step(now, self.cfg.batch_capacity)
        if not rows:
            return
        st = self.state
        idx = np.asarray(rows, dtype=np.int64)
        st.state[idx] = S_EXECUTING
        st.exec_start[idx] = now
        st.worker[idx] = wid
        w.idle = False
        w.exec_started = now
        w.batches += 1
        batch = _VectorBatch(gen=next(self._gen))
        self._append_slots(batch, rows, now)
        self._batches[wid] = batch
        self._schedule_step(wid, now, include_base=True)
        self.sched.record_depth(now)

    def _append_slots(self, batch: _VectorBatch, rows: List[int],
                      now: float) -> None:
        n = len(rows)
        ridx = np.asarray(rows, dtype=np.int64)
        if self.prefix_tree is None:
            # no cache: every slot is a miss-free full prefill, so the
            # whole join is one masked update (same values _make_slot
            # would produce row by row with cached == 0)
            st = self.state
            prs_a = st.prompt_tokens[ridx].copy()
            tgts_a = np.minimum(st.true_output_tokens[ridx],
                                st.max_tokens[ridx])
            cacheds_a = np.zeros(n, dtype=np.int64)
            st.cached_prompt_tokens[ridx] = 0
            st.led_prefill[ridx] = 0
            st.led_decode[ridx] = 0
            st.prefix_credit[ridx] = 0
            st.has_ledger[ridx] = True
            batch.nodes.extend([None] * n)
            batch.keys.extend([()] * n)
        else:
            prs, tgts, cacheds = [], [], []
            for i in rows:
                pr, tgt, cached, node, key = self._make_slot(i, now)
                prs.append(pr)
                tgts.append(tgt)
                cacheds.append(cached)
                batch.nodes.append(node)
                batch.keys.append(key)
            prs_a = np.asarray(prs, dtype=np.int64)
            tgts_a = np.asarray(tgts, dtype=np.int64)
            cacheds_a = np.asarray(cacheds, dtype=np.int64)
        if len(batch.idx) == 0:
            batch.idx = ridx
            batch.pr = prs_a
            batch.tgt = tgts_a
            batch.done = np.zeros(n, dtype=np.int64)
            batch.cached = cacheds_a
            return
        batch.idx = np.concatenate([batch.idx, ridx])
        batch.pr = np.concatenate([batch.pr, prs_a])
        batch.tgt = np.concatenate([batch.tgt, tgts_a])
        batch.done = np.concatenate(
            [batch.done, np.zeros(n, dtype=np.int64)])
        batch.cached = np.concatenate([batch.cached, cacheds_a])

    # --- iteration scheduling -------------------------------------------
    def _schedule_step(self, wid: int, now: float, *,
                       include_base: bool = False) -> None:
        w = self.workers[wid]
        batch = self._batches[wid]
        cfg = self.cfg
        if (not include_base and not cfg.mitigate_stragglers
                and not batch.pr.any()
                and (self.cost.jitter_sigma <= 0
                     or len(self.workers) == 1)
                and len(batch.idx) > 0 and int(batch.done.min()) >= 1
                and self._schedule_epoch(wid, now)):
            return
        pr, tgt, done = batch.pr, batch.tgt, batch.done
        budget = cfg.chunk_prefill_tokens
        if budget is None:
            take = pr.copy()
        else:
            # exact chunk apportioning in join order: slot i gets
            # min(pr_i, budget - sum(takes before i)), clipped at 0
            before = np.cumsum(pr) - pr
            take = np.clip(budget - before, 0, pr)
        emits = np.where(pr > 0, (take == pr) & (tgt > 0), done < tgt)
        n_emit = int(emits.sum())
        prefill_tokens = int(take.sum())
        jit = self._carry_jitter.pop(wid, None)
        if jit is None:
            jit = self.cost.jitter(self.rng)
        dt = self.cost.step_time(n_emit, prefill_tokens,
                                 include_base=include_base, jitter=jit)
        if w.slow:
            dt *= cfg.straggler_factor
        w.busy_until = now + dt
        w.busy_time += dt
        self.n_steps += 1
        self.heartbeats.beat(wid, now)
        self.stragglers.observe(wid, dt)
        batch.pending = (take, emits)
        batch.epoch = None
        self._push(now + dt, "step_done", (wid, batch.gen))

    def _schedule_epoch(self, wid: int, now: float) -> bool:
        """Try to collapse the next run of pure-decode iterations into
        one event. Legal only while nothing can observe the batch
        between boundaries: the epoch stops before the next disruption
        (failure/straggler onset/repair) and — when mid-flight joins
        are possible — the next arrival. Returns False to fall back to
        single-step.

        With continuous joins the epoch additionally stops at the min
        slot's retirement (a retirement frees a slot someone could
        join). Without joins the membership is frozen, and the object
        engine's interior retirements are *unobservable*: a finished
        slot moves to ``held`` with no completion stamp, no depth
        record, and no tree release until the whole batch drains. The
        only interior effect is the shrinking batch repricing
        ``decode_step_time`` — so the epoch runs through every
        retirement boundary to full drain (one event per batch instead
        of one per distinct retirement), repricing as slots retire.
        ``batch.ek`` records per-slot applied steps for the boundary
        application."""
        cfg = self.cfg
        w = self.workers[wid]
        batch = self._batches[wid]
        rem = batch.tgt - batch.done
        k_min = int(rem.min())
        drain = not cfg.continuous_joins
        k_cap = int(rem.max()) if drain else k_min
        if k_cap < 2:
            return False
        d = self._disrupts
        while d and d[0] < now:
            d.pop(0)
        cap_t = d[0] if d else math.inf
        if cfg.continuous_joins and len(batch.idx) < cfg.batch_capacity:
            # joins could fire at any boundary once work is queued
            if self.sched.queue_depth() > 0 or not self._stress_released:
                return False
            if self._ap < self._arr_ready:
                cap_t = min(cap_t, float(self._arr_t[self._ap]))
        n_emit = len(batch.idx)
        # retirement profile: after step s, ret_counts[s] slots leave
        ret_counts = None
        if k_cap > k_min:
            ret_counts = np.bincount(np.minimum(rem, k_cap)).tolist()
        cost, rng = self.cost, self.rng
        dt_base = cost.decode_step_time(n_emit)
        factor = cfg.straggler_factor if w.slow else 1.0
        carry = self._carry_jitter.pop(wid, None)
        t = now
        boundaries: List[float] = []
        k = 0
        n_act = n_emit
        busy = w.busy_time
        if cost.jitter_sigma <= 0 and cap_t == math.inf:
            # deterministic regime, nothing to cap at: jitter() returns
            # 1.0 without consuming rng state (x * 1.0 == x exactly),
            # so the draw and carry bookkeeping vanish and dt is
            # constant between retirements. Busy time still accumulates
            # one add per step to keep float rounding order identical.
            bapp = boundaries.append
            if ret_counts is None:
                segs = [(k_cap, n_emit)]
            else:
                uniq, cnts = np.unique(rem, return_counts=True)
                segs = []
                prev = 0
                alive = n_emit
                for u, c in zip(uniq.tolist(), cnts.tolist()):
                    segs.append((u - prev, alive))
                    alive -= c
                    prev = u
            for m, na in segs:
                dt = cost.decode_step_time(na)
                if factor != 1.0:
                    dt *= factor
                for _ in range(m):
                    t += dt
                    bapp(t)
                    busy += dt
            k = k_cap
        elif cost.jitter_sigma <= 0:
            # deterministic but a disruption is pending: per-step cap
            # check (the crossing step belongs to the next schedule
            # call; no jitter draw exists to carry)
            dt = dt_base if factor == 1.0 else dt_base * factor
            while k < k_cap:
                nt = t + dt
                if k >= 1 and nt >= cap_t:
                    break
                t = nt
                boundaries.append(t)
                busy += dt
                k += 1
                if ret_counts is not None and k < k_cap:
                    rn = ret_counts[k] if k < len(ret_counts) else 0
                    if rn:
                        n_act -= rn
                        dt_base = cost.decode_step_time(n_act)
                        dt = (dt_base if factor == 1.0
                              else dt_base * factor)
        else:
            while k < k_cap:
                jit = carry if carry is not None else cost.jitter(rng)
                carry = None
                dt = dt_base * jit
                if factor != 1.0:
                    dt *= factor
                nt = t + dt
                if k >= 1 and nt >= cap_t:
                    # the crossing step belongs to the next schedule
                    # call; its jitter draw is carried, keeping the rng
                    # stream identical to the object engine's
                    # one-draw-per-step
                    self._carry_jitter[wid] = jit
                    break
                t = nt
                boundaries.append(t)
                busy += dt
                k += 1
                if ret_counts is not None and k < k_cap:
                    rn = ret_counts[k] if k < len(ret_counts) else 0
                    if rn:
                        n_act -= rn
                        dt_base = cost.decode_step_time(n_act)
        w.busy_time = busy
        w.busy_until = boundaries[-1]
        self.n_steps += k
        self.n_epochs += 1
        self.heartbeats.beat(wid, now)
        batch.pending = None
        batch.epoch = boundaries
        batch.ek = k if k <= k_min else np.minimum(rem, k)
        self._push(boundaries[-1], "step_done", (wid, batch.gen))
        return True

    # --- iteration boundary ---------------------------------------------
    def _on_slot_prefilled(self, batch: _VectorBatch, s: int,
                           now: float) -> None:
        if self.prefix_tree is None:
            return
        key = batch.keys[s]
        if not key:
            return
        node, _ = self.prefix_tree.insert(key, now)
        old = batch.nodes[s]
        if old is not None:
            self.prefix_tree.release(old)
        self.prefix_tree.lock(node)
        batch.nodes[s] = node

    def _complete_row(self, i: int, dcount: int, node, now: float) -> int:
        if node is not None and self.prefix_tree is not None:
            self.prefix_tree.release(node)
        st = self.state
        st.exec_end[i] = now
        self.sched.complete(i, dcount, now)
        return 1

    def _apply_sequential(self, batch: _VectorBatch, now: float) -> int:
        """Per-slot boundary application in exact object order — used
        whenever a prefix tree is live, because retiring slot ``a`` may
        release pins that slot ``b``'s prefill-completion insert then
        evicts (order-dependent tree state). Mirrors the object
        engine's single loop verbatim."""
        st = self.state
        cfg = self.cfg
        take, emits = batch.pending
        done_n = 0
        keep: List[int] = []
        for s in range(len(batch.idx)):
            i = int(batch.idx[s])
            tk = int(take[s])
            if tk:
                batch.pr[s] -= tk
                st.led_prefill[i] += tk
                if batch.pr[s] <= 0:
                    self._on_slot_prefilled(batch, s, now)
            if emits[s]:
                batch.done[s] += 1
                st.led_decode[i] += 1
                if batch.done[s] == 1 and math.isnan(st.prefill_end[i]):
                    st.prefill_end[i] = now
            finished = batch.pr[s] <= 0 and batch.done[s] >= batch.tgt[s]
            if not finished:
                keep.append(s)
            elif cfg.continuous_joins:
                done_n += self._complete_row(i, int(batch.done[s]),
                                             batch.nodes[s], now)
                batch.nodes[s] = None
            else:
                batch.held.append((i, int(batch.done[s]), batch.nodes[s],
                                   int(batch.cached[s])))
                batch.nodes[s] = None
        self._compress(batch, keep)
        return done_n

    def _apply_vectorized(self, batch: _VectorBatch, now: float) -> int:
        """Masked-array boundary application (no prefix tree: slot
        bookkeeping is order-independent, so progress and retirement
        can be two-phase without changing any observable)."""
        st = self.state
        cfg = self.cfg
        idx = batch.idx
        take, emits = batch.pending
        if take.any():
            batch.pr -= take
            st.led_prefill[idx] += take
        if emits.any():
            batch.done += emits
            st.led_decode[idx] += emits
            first = emits & (batch.done == 1)
            if first.any():
                fidx = idx[first]
                unset = np.isnan(st.prefill_end[fidx])
                if unset.any():
                    st.prefill_end[fidx[unset]] = now
        done_n = 0
        finished = (batch.pr <= 0) & (batch.done >= batch.tgt)
        if finished.any():
            keep = [int(s) for s in np.nonzero(~finished)[0]]
            for s in np.nonzero(finished)[0]:
                s = int(s)
                i = int(idx[s])
                if cfg.continuous_joins:
                    done_n += self._complete_row(i, int(batch.done[s]),
                                                 batch.nodes[s], now)
                else:
                    batch.held.append((i, int(batch.done[s]),
                                       batch.nodes[s],
                                       int(batch.cached[s])))
                batch.nodes[s] = None
            self._compress(batch, keep)
        return done_n

    @staticmethod
    def _compress(batch: _VectorBatch, keep: List[int]) -> None:
        if len(keep) == len(batch.idx):
            return
        sel = np.asarray(keep, dtype=np.int64)
        batch.idx = batch.idx[sel]
        batch.pr = batch.pr[sel]
        batch.tgt = batch.tgt[sel]
        batch.done = batch.done[sel]
        batch.cached = batch.cached[sel]
        batch.nodes = [batch.nodes[s] for s in keep]
        batch.keys = [batch.keys[s] for s in keep]

    def _finish_step(self, wid: int, gen: int, now: float) -> int:
        w = self.workers[wid]
        batch = self._batches.get(wid)
        if batch is None or batch.gen != gen or not w.alive:
            return 0                       # stale event (aborted batch)
        st = self.state
        cfg = self.cfg
        done_n = 0
        if batch.epoch is not None:
            # epoch boundary: the collapsed iterations land at once.
            # Epoch legality guarantees no first tokens and no joins in
            # between; ``ek`` is a scalar when no slot crossed its
            # retirement, a per-slot array when a drain epoch ran
            # through retirements (whose held-until-drain stamps all
            # happen here, exactly as the object engine's do).
            batch.done += batch.ek
            st.led_decode[batch.idx] += batch.ek
            batch.epoch = None
            batch.ek = 0
            finished = batch.done >= batch.tgt
            if finished.any():
                keep = [int(s) for s in np.nonzero(~finished)[0]]
                for s in np.nonzero(finished)[0]:
                    s = int(s)
                    i = int(batch.idx[s])
                    if cfg.continuous_joins:
                        done_n += self._complete_row(
                            i, int(batch.done[s]), batch.nodes[s], now)
                    else:
                        batch.held.append((i, int(batch.done[s]),
                                           batch.nodes[s],
                                           int(batch.cached[s])))
                    batch.nodes[s] = None
                self._compress(batch, keep)
        elif self.prefix_tree is not None:
            done_n = self._apply_sequential(batch, now)
        else:
            done_n = self._apply_vectorized(batch, now)
        batch.pending = None

        if cfg.continuous_joins and len(batch.idx) > 0:
            free = cfg.batch_capacity - len(batch.idx)
            if free > 0 and self.sched.queue_depth() > 0:
                joined = self.sched.dispatch_step(now, free)
                if joined:
                    jidx = np.asarray(joined, dtype=np.int64)
                    st.state[jidx] = S_EXECUTING
                    st.exec_start[jidx] = now
                    st.worker[jidx] = wid
                    self._append_slots(batch, joined, now)
                    self.n_joins += len(joined)
                    self.sched.record_depth(now)

        if len(batch.idx) > 0:
            self._schedule_step(wid, now)
        else:
            # batch drained: flush held retirements in join order
            # (bulk: node releases first, in join order, then stamps +
            # EMA feedback — no observer sits between them)
            held = batch.held
            if held:
                if self.prefix_tree is not None:
                    for (_i, _d, node, _c) in held:
                        if node is not None:
                            self.prefix_tree.release(node)
                rows = [h[0] for h in held]
                st.exec_end[np.asarray(rows, dtype=np.int64)] = now
                done_n += self.sched.complete_many(
                    rows, [h[1] for h in held], now)
            del self._batches[wid]
            w.idle = True
            w.busy_until = now
        if done_n:
            self.sched.record_depth(now)
        return done_n

    # --- failure / repair -----------------------------------------------
    def _fail_worker(self, wid: int, now: float) -> None:
        w = self.workers[wid]
        if not w.alive:
            return
        w.alive = False
        w.idle = False
        self._carry_jitter.pop(wid, None)
        batch = self._batches.pop(wid, None)
        rows: List[int] = []
        if batch is not None:
            rows = [int(i) for i in batch.idx] \
                + [h[0] for h in batch.held]
        if self.prefix_tree is not None:
            self.prefix_tree.clear()
            self.n_cache_invalidations += 1
        if rows:
            w.busy_time -= max(w.busy_until - now, 0.0)
            st = self.state
            for i in rows:
                st.prefill_end[i] = np.nan
                st.has_ledger[i] = False
                self.sched.fail(i, now)
                self.n_failed_dispatches += 1
        repair_at = now + self.cfg.repair_time
        self._push(repair_at, "repair", wid)
        bisect.insort(self._disrupts, repair_at)
        self.sched.record_depth(now)

    # --- telemetry (array snapshot, optionally strided) -----------------
    def _slot_kv_pages(self, now: float) -> int:
        pages = 0
        for batch in self._batches.values():
            applied = 0
            if batch.epoch is not None:
                applied = bisect.bisect_left(batch.epoch, now)
            if len(batch.idx):
                # min with tgt: inside a drain epoch a slot past its
                # retirement boundary is frozen at its target (the
                # object engine's held rows stop growing)
                tokens = (self.state.prompt_tokens[batch.idx]
                          - batch.cached - batch.pr
                          + np.minimum(batch.done + applied, batch.tgt))
                live = tokens[tokens > 0]
                if live.size:
                    pages += int(pages_needed_array(
                        live, KV_PAGE_TOKENS).sum())
            for (i, dcount, _node, cached) in batch.held:
                tokens = (int(self.state.prompt_tokens[i]) - cached
                          + dcount)
                if tokens > 0:
                    pages += _pages_needed(tokens)
        return pages

    def _sample_telemetry(self, now: float) -> None:
        active = sum(len(b.idx) + len(b.held)
                     for b in self._batches.values())
        busy_now = sum(1 for w in self.workers if not w.idle and w.alive)
        alive = max(sum(1 for w in self.workers if w.alive), 1)
        pool_pages = (len(self.workers) * self.cfg.batch_capacity
                      * _pages_needed(KV_MAX_CONTEXT_TOKENS))
        used_pages = self._slot_kv_pages(now) if busy_now else 0
        if self.prefix_tree is not None and self.prefix_tree.total_pages():
            used_pages += _pages_needed(self.prefix_tree.total_pages()
                                        * self.cfg.prefix_page_tokens)
        occupancy = min(used_pages / max(pool_pages, 1), 1.0)
        mem = GPU_MEM_PLATEAU_GB + GPU_MEM_DYNAMIC_GB * occupancy
        self.telemetry.append(TelemetrySample(
            time=now,
            gpu_util=0.85 + 0.07 * (busy_now / alive)
            if busy_now else 0.05,
            gpu_mem_gb=mem,
            active_requests=active,
            queue_depth=self.sched.queue_depth(),
        ))

    # --- run loop ---------------------------------------------------------
    def run(self) -> RunMetrics:
        cfg = self.cfg
        plan = self.plan
        total = self.state.n
        n_cal = plan.n_calibration
        # arrivals live in sorted arrays, merged with the event heap by
        # (time, eseq); their eseqs reproduce the object engine's push
        # order (calibration block, then fail/slow/telemetry pushes,
        # then the stress block at release)
        arr_t = plan.arrival.astype(np.float64).copy()
        arr_es = np.zeros(total, dtype=np.int64)
        arr_es[:n_cal] = np.arange(n_cal)
        self._eseq = itertools.count(n_cal)
        for ft in cfg.fail_times:
            self._push(ft, "fail", cfg.fail_worker)
        if cfg.straggler_worker is not None:
            self._push(cfg.straggler_after, "slow", cfg.straggler_worker)
        # the periodic telemetry tick lives outside the heap (a scalar
        # cursor): at big N it is the single most frequent event, and
        # the merge below orders it by the same (time, eseq) key the
        # object engine's heap entry would carry — the eseq is
        # allocated at the exact program points the object pushes at
        tick_t = 0.0
        tick_e = next(self._eseq)
        self._arr_t = arr_t
        self._arr_es = arr_es
        self._ap = 0
        self._arr_ready = n_cal
        self._stress_released = n_cal >= total
        stride = max(cfg.telemetry_stride, 1)
        tick = 0
        completed = 0
        ev = self._events
        workers = self.workers
        # python-list mirrors of the arrival arrays: the merge below
        # runs once per event and np-scalar unboxing dominates it
        arrl_t = arr_t.tolist()
        arrl_e = arr_es.tolist()
        pop = heapq.heappop
        while completed < total and (ev or tick_t is not None
                                     or self._ap < self._arr_ready):
            # three-way merge by (time, eseq): heap top, telemetry
            # cursor, arrival cursor — identical order to the object
            # engine's single heap
            kind = None
            from_tick = False
            if ev:
                h = ev[0]
                ht = h[0]
                he = h[1]
                if tick_t is not None and (tick_t < ht or
                                           (tick_t == ht
                                            and tick_e < he)):
                    ht, he, from_tick = tick_t, tick_e, True
            elif tick_t is not None:
                ht, he, from_tick = tick_t, tick_e, True
            else:
                ht = None
            ap = self._ap
            if ap < self._arr_ready:
                at = arrl_t[ap]
                if ht is None or at < ht or (at == ht
                                             and arrl_e[ap] < he):
                    now, kind, payload = at, "arrival", ap
                    self._ap = ap + 1
            if kind is None:
                if from_tick:
                    now, kind, payload = tick_t, "telemetry", None
                    tick_t = None
                else:
                    now, _, kind, payload = pop(ev)
            # Sec. II-G: the stress burst is submitted once the
            # calibration phase has fully drained.
            if not self._stress_released and completed >= n_cal:
                self._stress_released = True
                self.phase_boundary = now
                k = total - n_cal
                arr_t[n_cal:] = now + plan.arrival[n_cal:]
                base = next(self._eseq)
                arr_es[n_cal:] = np.arange(base, base + k)
                self._eseq = itertools.count(base + k)
                self._arr_ready = total
                arrl_t[n_cal:] = arr_t[n_cal:].tolist()
                arrl_e[n_cal:] = arr_es[n_cal:].tolist()
            if kind == "telemetry":
                # the tick cadence must survive striding: telemetry
                # pops participate in stress-release timing. Striding
                # only skips the (costly) snapshot.
                if tick % stride == 0:
                    self._sample_telemetry(now)
                tick += 1
                if completed < total:
                    tick_t = now + cfg.telemetry_interval
                    tick_e = next(self._eseq)
            elif kind == "arrival":
                self.sched.submit(payload, now)
                self.sched.record_depth(now)
                self._try_dispatch(now)
            elif kind == "batch_start":
                self._pending_batch_start[payload] = False
                self._start_batch(payload, now)
            elif kind == "step_done":
                completed += self._finish_step(payload[0], payload[1],
                                               now)
                self._try_dispatch(now)
            elif kind == "fail":
                self._fail_worker(payload, now)
            elif kind == "repair":
                workers[payload].alive = True
                workers[payload].idle = True
                self._try_dispatch(now)
            elif kind == "slow":
                workers[payload].slow = True
            else:
                raise ValueError(f"unknown simulator event {kind!r}")
        busy = sum(w.busy_time for w in workers) / max(len(workers), 1)
        return summarize_run_arrays(
            self.sched.policy,
            self.sched.config.bias_enabled,
            self.state,
            self.sched.completed_order.view(),
            busy_time=busy,
            n_failed_dispatches=self.n_failed_dispatches,
        )

    @classmethod
    def from_scheduler(cls, scheduler, plan,
                       config: Optional[SimConfig] = None,
                       cost_model: Optional[CostModel] = None,
                       rng: Optional[random.Random] = None
                       ) -> "VectorWorkerSimulator":
        """Build from a freshly-constructed :class:`DriftScheduler`
        (the factory path: the vector core re-implements the scheduler
        internally, so only its configuration is carried over)."""
        pol = scheduler.policy
        return cls(plan, config, cost_model, policy=pol.name,
                   drift_config=scheduler.config,
                   max_new_per_step=scheduler.max_new_per_step, rng=rng,
                   aging_threshold=getattr(pol, "aging_threshold", 240.0),
                   aging_rate=getattr(pol, "aging_rate", 1.0))


class StepVectorizedWorkerSimulator(WorkerSimulator):
    """Composed (cluster) fast path behind ``backend="vector"``.

    A :class:`WorkerSimulator` subclass that keeps the real
    :class:`DriftScheduler` and :class:`Request` objects — so routing,
    reroute, stealing, autoscaling probes and cluster metrics read the
    exact surfaces they always did — but collapses runs of pure-decode
    iterations of a *full* batch into one epoch event when the cost
    model is jitter-free (``jitter_sigma <= 0``; the cluster shares one
    rng across replicas, so per-iteration draws cannot be batched
    without reordering the stream).

    Epochs are invisible to the cluster: batch membership (what
    ``token_mass``/``inflight_requests`` read) only changes at epoch
    ends, joins are impossible while the batch is full, and a worker
    failure mid-epoch truncates exactly — the iterations that the
    object engine would have completed before the failure are applied,
    the in-flight one is discarded, and ``busy_time`` is corrected by
    the inherited un-spend formula. The only tolerated divergence is
    float-ulp noise in ``busy_time`` after such a truncation.
    """

    def __init__(self, scheduler, plan=None,
                 config: Optional[SimConfig] = None,
                 cost_model: Optional[CostModel] = None,
                 sink=None, rng=None, complete_hook=None,
                 trace=None) -> None:
        if sink is None:
            raise ValueError(
                "StepVectorizedWorkerSimulator is the composed "
                "(sink-driven) vector path; standalone vector runs use "
                "VectorWorkerSimulator")
        super().__init__(scheduler, plan, config, cost_model, sink=sink,
                         rng=rng, complete_hook=complete_hook,
                         trace=trace)
        # wid -> (batch gen, epoch boundary times)
        self._epochs: Dict[int, Tuple[int, List[float]]] = {}
        self.n_epochs = 0            # epoch events (each covers >=2 steps)

    def _schedule_step(self, wid: int, now: float, *,
                       include_base: bool = False) -> None:
        cfg = self.cfg
        batch = self._batches[wid]
        w = self.workers[wid]
        if (not include_base
                and not cfg.mitigate_stragglers
                and cfg.straggler_worker is None
                and self.cost.jitter_sigma <= 0
                and not self.trace.enabled
                and len(batch.slots) == cfg.batch_capacity
                and all(s.prefill_remaining <= 0 for s in batch.slots)
                and all(s.decode_done >= 1 for s in batch.slots)):
            k = min(s.target - s.decode_done for s in batch.slots)
            if k >= 2:
                dt = self.cost.decode_step_time(len(batch.slots))
                if w.slow:
                    dt *= cfg.straggler_factor
                # accumulate per step: k separate adds round exactly
                # like k object-engine iterations would
                t = now
                boundaries: List[float] = []
                for _ in range(k):
                    t = t + dt
                    boundaries.append(t)
                    w.busy_time += dt
                w.busy_until = boundaries[-1]
                self.n_steps += k
                self.n_epochs += 1
                self.heartbeats.beat(wid, now)
                self._epochs[wid] = (batch.gen, boundaries)
                batch.pending = []
                self._push(boundaries[-1], "step_done", (wid, batch.gen))
                return
        super()._schedule_step(wid, now, include_base=include_base)

    def _finish_step(self, wid: int, gen: int, now: float) -> int:
        ep = self._epochs.get(wid)
        if ep is not None and ep[0] == gen:
            del self._epochs[wid]
            batch = self._batches.get(wid)
            w = self.workers[wid]
            if batch is None or batch.gen != gen or not w.alive:
                return 0
            k = len(ep[1])
            # fold the first k-1 iterations in silently (no retirement,
            # no first token, no joins are possible before the epoch
            # end by construction), then let the inherited boundary
            # logic run the k-th: retirement, joins, rescheduling and
            # depth recording all behave exactly as in the object run.
            for slot in batch.slots:
                slot.decode_done += k - 1
                self.token_ledger[slot.req.req_id][1] += k - 1
            batch.pending = [(slot, 0, True) for slot in batch.slots]
        return super()._finish_step(wid, gen, now)

    def _fail_worker(self, wid: int, now: float) -> None:
        ep = self._epochs.pop(wid, None)
        if ep is not None:
            batch = self._batches.get(wid)
            w = self.workers[wid]
            if batch is not None and batch.gen == ep[0] and w.alive:
                boundaries = ep[1]
                k = len(boundaries)
                # iterations with a boundary strictly before `now`
                # completed in the object trajectory; one more was in
                # flight. The epoch pre-charged all k to n_steps; give
                # back the never-scheduled remainder. busy_time needs
                # no correction here: the inherited un-spend
                # (busy_until - now) removes the uncompleted tail in
                # one subtraction. Decode progress and ledger entries
                # die with the requeue either way.
                j = bisect.bisect_left(boundaries, now)
                self.n_steps -= k - min(j + 1, k)
        super()._fail_worker(wid, now)
