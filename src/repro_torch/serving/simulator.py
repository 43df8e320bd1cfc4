"""Discrete-event simulation of one serving worker group (a *replica*).

Drives the *real* DriftScheduler (the identical state machine the JAX
engine uses) against a calibrated service-time model, reproducing the
paper's protocol: two-phase arrivals (calibration + stress), batch
capacity 32, batch wait 0.01 s, GPU saturation, telemetry sampling.

Two execution modes, selected by :attr:`SimConfig.step_engine`:

* **atomic** (default, the paper's protocol): a dispatched batch is
  priced as one unit by :meth:`CostModel.batch_time` and runs to
  completion; every member completes at batch end. This is the
  calibration target of the L4 cost models.
* **step engine** (``step_engine=True``): iteration-level continuous
  batching. The worker holds a :class:`RunningBatch` of per-slot
  progress (prefill tokens remaining, tokens decoded); every event is
  ONE iteration priced by :meth:`CostModel.step_time`. Prefill is
  chunked against a per-step token budget
  (``chunk_prefill_tokens``, Sarathi-style), free slots admit queued
  requests at every iteration boundary (``continuous_joins``, capped by
  the scheduler's ``max_new_per_step``), requests retire — and stamp
  real per-request TTFT (``Request.prefill_end``, the iteration that
  emitted their first token) and completion times — at their own
  iteration, and worker failure preempts at the iteration boundary:
  already-completed members stay completed, unfinished slots re-queue
  with estimates preserved (at-most-once feedback).

  With ``prefix_cache=True`` the worker group additionally models a
  replica-wide **shared-prefix radix cache** (``kv_cache.PrefixTree``
  over a ``PagedAllocator`` page budget): a joining request whose
  prompt starts with a resident shared prefix skips prefilling the
  cached full pages (chunked prefill starts at the cached boundary),
  a finished prefill inserts its shareable full pages for future
  requests, unreferenced LRU leaves evict under page pressure at
  iteration boundaries, and worker failure invalidates the whole cache
  (the KV pool died with the device — subsequent retries re-prefill in
  full). Per-request cache credits live in :attr:`prefix_ledger`;
  conservation becomes ``cached + chunk-prefilled == prompt`` and
  ``emissions == observed``.

  **Parity mode** — ``chunk_prefill_tokens=None`` (unbounded) and
  ``continuous_joins=False`` — degenerates the step engine to the
  atomic contract: the whole batch prefills in its first iteration, no
  one joins mid-flight, and retirements are held until the batch
  drains, so every member completes at batch end. Because
  ``batch_time`` is exactly ``t_base`` plus the telescoped sum of
  ``step_time`` (cost_model.py), parity-mode results reproduce the
  atomic path bit-for-bit modulo float summation order (locked by
  tests/test_step_engine.py) and the existing paper-validation
  calibrations stay meaningful.

:class:`WorkerSimulator` can run standalone (its own event loop, the
paper's single-replica protocol) or be composed: when constructed with
an external event ``sink`` it emits its events there instead of its own
heap, and the owner drives it through :meth:`handle_event`. The
cluster-level simulator (``repro.cluster.simulator``) composes N of
these under one heap and one seed.

Beyond-paper cluster features (DESIGN.md §7) are simulated faithfully:

* multiple workers (the paper uses 1; scale-out experiments use more);
* worker failure injection — in-flight batches abort, requests re-queue
  at the head of their tenant queue with their estimate preserved and
  NO bias feedback (at-most-once feedback), the worker rejoins after
  ``repair_time``;
* straggler hedging — a slowed worker's batches take ``slow_factor``x
  longer; the StragglerDetector flags it and (if enabled) the engine
  stops dispatching to it until it recovers.

Determinism: one ``random.Random(seed)`` drives everything.
"""

from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..core.request import Request, RequestState
from ..core.scheduler import DriftScheduler
from ..distributed.fault_tolerance import HeartbeatMonitor, StragglerDetector
from ..obs import events as tr
from ..obs import resolve_recorder
from ..workload.generator import ArrivalPlan
from .cost_model import CostModel, L4_QWEN_1_8B
from .kv_cache import PagedAllocator, PrefixTree, prefix_page_key
from .metrics import RunMetrics, summarize_run


@dataclass(frozen=True)
class SimConfig:
    batch_capacity: int = 32          # paper Sec. III-B
    batch_wait: float = 0.01          # paper Sec. III-B
    n_workers: int = 1
    telemetry_interval: float = 0.2   # paper: 200 ms nvidia-smi sampling
    # --- iteration-level execution core (continuous batching) ---
    # step_engine=False keeps the paper's atomic-batch pricing; True
    # switches to per-iteration events (see module docstring).
    step_engine: bool = False
    # per-STEP prefill token budget shared by joining slots in join
    # order (None = unbounded: a joining prompt prefills fully in its
    # first iteration). Only meaningful with step_engine=True.
    chunk_prefill_tokens: Optional[int] = None
    # admit queued requests into freed slots at iteration boundaries;
    # False = atomic batches (the legacy/parity contract: retirements
    # held to batch drain). Only meaningful with step_engine=True.
    continuous_joins: bool = True
    # which serving phase this worker group executes ("unified",
    # "prefill", "decode") — set by the cluster layer under P/D
    # disaggregation. Prefill-phase slots retire at prefill completion
    # (no decode); decode-phase work arrives with its KV handed off.
    phase: str = "unified"
    # --- shared-prefix KV cache (radix tree; step engine only) ---
    # model a replica-wide prefix cache: requests carrying a
    # prefix_group skip prefilling resident full pages of their shared
    # prompt prefix. prefix_cache_pages bounds residency (page size
    # KV_PAGE_TOKENS); LRU leaves evict under pressure.
    prefix_cache: bool = False
    prefix_cache_pages: int = 4096
    # token granularity of one prefix-cache page (the radix tree's
    # shareable unit). Default matches the telemetry page model
    # (KV_PAGE_TOKENS = 128); the engine↔simulator parity suite sets
    # it to the engine's device page_size so cached-token accounting
    # agrees across both executors.
    prefix_page_tokens: int = 128
    # fault injection
    fail_times: Tuple[float, ...] = ()    # absolute failure times
    fail_worker: int = 0                  # which worker fails
    repair_time: float = 30.0
    # straggler injection
    straggler_worker: Optional[int] = None
    straggler_after: float = 0.0
    straggler_factor: float = 3.0
    mitigate_stragglers: bool = False
    # hedged dispatch (Dean & Barroso): when a batch has been executing
    # longer than hedge_factor x its cost-model estimate and another
    # worker is idle, speculatively re-execute it there; first completion
    # wins, the loser's results are discarded (GPU batches are not
    # cancellable mid-flight, so the loser runs to completion).
    # Batch-granular by nature — mutually exclusive with step_engine.
    hedge: bool = False
    hedge_factor: float = 2.5
    # --- execution backend selection ---
    # "object": this event-heap, Request-object engine (the oracle).
    # "vector": the flat-array core in repro.serving.vector_sim —
    # standalone runs get VectorWorkerSimulator, sink-driven (cluster)
    # replicas get StepVectorizedWorkerSimulator. Construct through
    # make_worker_simulator(); WorkerSimulator itself refuses
    # backend="vector" so the fast path can never silently fall back
    # to the object engine.
    backend: str = "object"
    # sample every Nth telemetry tick (vector backend; the 200 ms tick
    # cadence itself is kept — ticks participate in event ordering —
    # only the stored snapshots are thinned). 1 = every tick (exact).
    telemetry_stride: int = 1
    # record every Nth queue-depth sample (vector backend). 1 = exact.
    depth_stride: int = 1
    seed: int = 0


@dataclass
class WorkerState:
    busy_until: float = 0.0
    idle: bool = True
    alive: bool = True
    slow: bool = False
    busy_time: float = 0.0
    batches: int = 0
    exec_started: float = 0.0
    expected_exec: float = 0.0
    hedged: bool = False           # this batch already has a hedge copy


@dataclass
class SlotProgress:
    """Per-request execution state inside a :class:`RunningBatch`."""

    req: Request
    prefill_remaining: int      # prompt tokens not yet prefilled here
    target: int                 # decode tokens to emit (0 on prefill phase)
    decode_done: int = 0        # tokens emitted so far
    # --- prefix-cache state (SimConfig.prefix_cache) ---
    cached_tokens: int = 0      # prompt tokens served from the cache
    prefix_key: tuple = ()      # page key of the shareable prefix
    prefix_node: object = None  # locked PrefixNode pinning cached pages


@dataclass
class RunningBatch:
    """One worker's live continuous batch (step engine only).

    ``pending`` is the iteration currently executing, precomputed when
    it was scheduled: (slot, prefill_tokens_this_step, emits_token).
    ``finished`` holds retired members awaiting batch drain when
    mid-flight joins are disabled (the atomic/parity contract).
    ``gen`` invalidates in-flight step events after an abort."""

    slots: List[SlotProgress]
    gen: int
    pending: List[Tuple[SlotProgress, int, bool]] = field(
        default_factory=list)
    finished: List[SlotProgress] = field(default_factory=list)


# --- telemetry memory model (satellite of the step-engine rework) ------
# The paper platform preallocates its paged KV pool vLLM-style, so
# nvidia-smi shows a ~14 GB plateau (weights ~3.7 GB FP16 1.8B + the
# reserved pool + CUDA context). What *moves* with load is the working
# set: pages actually holding KV (prompt + decoded tokens, page-granular
# like kv_cache.PagedAllocator.pages_needed) drive allocator state and
# activation workspace. We model mem as plateau + workspace scaled by
# pool occupancy, so telemetry responds to chunked prefill (pages
# materialise as tokens do) while reproducing the paper's Fig 9 plateau.
KV_PAGE_TOKENS = 128                  # kv_cache.PagedPool default page
KV_MAX_CONTEXT_TOKENS = 2048          # per-slot pool sizing: prompt+output
GPU_MEM_PLATEAU_GB = 14.0             # weights + reserved pool + context
GPU_MEM_DYNAMIC_GB = 1.2              # workspace swing at full occupancy


def _pages_needed(n_tokens: int) -> int:
    """Mirror of ``kv_cache.PagedAllocator.pages_needed`` at the
    telemetry page size (kept as a module-level helper: telemetry page
    math must not depend on whether a prefix cache was configured)."""
    return max(1, math.ceil(n_tokens / KV_PAGE_TOKENS))


@dataclass
class TelemetrySample:
    time: float
    gpu_util: float
    gpu_mem_gb: float
    active_requests: int
    queue_depth: int


class WorkerSimulator:
    """Event-driven worker group: arrivals -> DriftScheduler -> workers."""

    def __init__(self, scheduler: DriftScheduler,
                 plan: Optional[ArrivalPlan] = None,
                 config: Optional[SimConfig] = None,
                 cost_model: Optional[CostModel] = None,
                 sink: Optional[Callable[[float, str, object], None]] = None,
                 rng: Optional[random.Random] = None,
                 complete_hook: Optional[
                     Callable[[Request, float], bool]] = None,
                 trace=None) -> None:
        """``complete_hook(req, now) -> bool``, when given, is consulted
        as each request finishes: returning True means the owner took
        the request over (e.g. a P/D prefill replica handing the
        prefilled request off for decode elsewhere) and the normal
        completion path — ``sched.complete`` and its drift feedback —
        must not run for it. Disables hedged dispatch: intercepted
        requests never reach COMPLETED inside this simulator, so the
        hedge-loser no-op guard cannot work.

        ``trace`` is an observability recorder
        (:class:`repro.obs.TraceRecorder`); None resolves the
        process-global one (the no-op sentinel unless installed via
        ``repro.obs.set_recorder``). Tracing is RNG-free and changes no
        control flow: traced runs are bit-identical to untraced ones."""
        self.sched = scheduler
        self.trace = resolve_recorder(trace)
        # replica id stamped on emitted events; the cluster layer sets
        # it after construction (None = standalone / unset)
        self.trace_rid: Optional[int] = None
        if self.trace.enabled:
            self.sched.drift.trace = self.trace
        self._complete_hook = complete_hook
        self.plan = plan
        self.cfg = config or SimConfig()
        if self.cfg.backend not in ("object", "vector"):
            raise ValueError(
                f"unknown SimConfig.backend {self.cfg.backend!r} "
                "(expected 'object' or 'vector')")
        if self.cfg.backend == "vector" and type(self) is WorkerSimulator:
            # no-silent-fallback guard: constructing the object engine
            # under backend="vector" would quietly run the slow path
            # (and look like "vectorization has no speedup"). Vector
            # subclasses pass; direct construction must go through
            # make_worker_simulator().
            raise ValueError(
                "SimConfig.backend='vector' must be constructed via "
                "make_worker_simulator() (or the vector classes in "
                "repro.serving.vector_sim); refusing to silently run "
                "the object engine")
        c = self.cfg.chunk_prefill_tokens
        if c is not None and c < 1:
            raise ValueError(
                f"chunk_prefill_tokens must be >= 1 or None, got {c}")
        if self.cfg.step_engine:
            if self.cfg.hedge:
                raise ValueError(
                    "hedged dispatch is batch-granular and incompatible "
                    "with the iteration-level step engine")
        elif c is not None:
            # a budget on the atomic path would be silently ignored and
            # misread as "chunking has no effect" — refuse instead
            raise ValueError(
                "chunk_prefill_tokens requires step_engine=True: the "
                "atomic-batch path prefills whole prompts by definition")
        elif self.cfg.prefix_cache:
            # same refusal logic: the atomic path prices whole batches
            # and never consults per-slot prefill progress, so a cache
            # there would be silently inert
            raise ValueError(
                "prefix_cache requires step_engine=True: only the "
                "iteration-level engine prefills from a cached boundary")
        self.cost = cost_model or L4_QWEN_1_8B
        self.rng = rng or random.Random(self.cfg.seed)
        self._sink = sink
        self.workers = [WorkerState() for _ in range(self.cfg.n_workers)]
        self.heartbeats = HeartbeatMonitor(timeout=10.0)
        self.stragglers = StragglerDetector()
        self.telemetry: List[TelemetrySample] = []
        self.n_failed_dispatches = 0
        self.n_hedges = 0
        self.n_hedge_wins = 0
        self.n_steps = 0                   # step-engine iterations run
        self.n_joins = 0                   # mid-flight slot joins
        self.phase_boundary: float = 0.0   # set when the stress burst fires
        # --- shared-prefix radix cache (replica-wide KV reuse) ---
        self.prefix_tree: Optional[PrefixTree] = None
        if self.cfg.prefix_cache:
            self.prefix_tree = PrefixTree(PagedAllocator(
                n_pages=self.cfg.prefix_cache_pages,
                page_size=self.cfg.prefix_page_tokens, pages_per_seq=1))
        self.n_prefix_hits = 0             # slots that found resident pages
        self.n_prefix_misses = 0           # shareable prefixes that found none
        self.prefix_tokens_saved = 0       # prefill tokens never re-computed
        self.n_cache_invalidations = 0     # failure-driven cache wipes
        # req_id -> prompt tokens served from the cache (the third leg
        # of token conservation: prefix_ledger + token_ledger[0] ==
        # prompt_tokens for every completed request)
        self.prefix_ledger: Dict[int, int] = {}
        # per-request token accounting (step engine): req_id ->
        # [prefill tokens processed, decode tokens emitted]. Reset on
        # abort (preempted iterations were never observed), so for every
        # completed request it must equal [prompt_tokens, observed]
        # (conservation, locked by tests/test_step_engine.py).
        self.token_ledger: Dict[int, List[int]] = {}
        self._events: List[tuple] = []
        self._eseq = itertools.count()
        self._gen = itertools.count(1)
        self._pending_batch_start: Dict[int, bool] = {}
        self._inflight: Dict[int, List[Request]] = {}      # atomic mode
        self._batches: Dict[int, RunningBatch] = {}        # step mode

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: str, payload=None) -> None:
        if self._sink is not None:
            self._sink(t, kind, payload)
        else:
            heapq.heappush(self._events, (t, next(self._eseq), kind, payload))

    def handle_event(self, now: float, kind: str, payload=None) -> int:
        """Process one event; returns the number of completions it
        produced. Used by :meth:`run` and by external composers (the
        cluster simulator) alike. ``telemetry`` is loop-owned and not
        handled here."""
        if kind == "arrival":
            if self.trace.enabled and self._sink is None:
                # standalone: this simulator IS the front door. Composed
                # replicas skip this — the cluster already emitted
                # arrive/admit/route before handing the request over.
                self.trace.emit(now, tr.ARRIVE, req_id=payload.req_id,
                                rid=self.trace_rid,
                                tenant=payload.tenant.label)
            self.sched.submit(payload, now)
            if self.trace.enabled and self._sink is None:
                self.trace.emit(now, tr.ADMIT, req_id=payload.req_id,
                                rid=self.trace_rid,
                                tenant=payload.tenant.label,
                                est_budget=payload.estimate.t_budget)
            self.sched.queues.record_depth(now)
            self._try_dispatch(now)
        elif kind == "batch_start":
            wid = payload
            self._pending_batch_start[wid] = False
            self._start_batch(wid, now)
        elif kind == "batch_done":
            wid, reqs, aborted = payload
            done = self._finish_batch(wid, reqs, aborted, now)
            self._try_dispatch(now)
            return done
        elif kind == "step_done":
            wid, gen = payload
            done = self._finish_step(wid, gen, now)
            self._try_dispatch(now)
            return done
        elif kind == "fail":
            self._fail_worker(payload, now)
        elif kind == "repair":
            self.workers[payload].alive = True
            self.workers[payload].idle = True
            if self.trace.enabled:
                self.trace.emit(now, tr.WORKER_REPAIR, rid=self.trace_rid,
                                wid=payload)
            self._try_dispatch(now)
        elif kind == "slow":
            self.workers[payload].slow = True
        elif kind == "kick":
            # external composer enqueued work directly (e.g. a cluster
            # reroute); just re-evaluate dispatch
            self._try_dispatch(now)
        else:
            raise ValueError(f"unknown simulator event {kind!r}")
        return 0

    def run(self) -> RunMetrics:
        if self.plan is None:
            raise ValueError("standalone run() needs an ArrivalPlan")
        if self._sink is not None:
            raise ValueError("externally-driven simulator has no run loop")
        if self.trace.enabled:
            self.trace.begin_segment(
                f"worker:{self.sched.policy.name}"
                f"{':step' if self.cfg.step_engine else ''}")
        cfg = self.cfg
        n_cal = len(self.plan.calibration)
        for t, req in self.plan.calibration:
            self._push(t, "arrival", req)
        for ft in cfg.fail_times:
            self._push(ft, "fail", cfg.fail_worker)
        if cfg.straggler_worker is not None:
            self._push(cfg.straggler_after, "slow", cfg.straggler_worker)
        self._push(0.0, "telemetry", None)

        total = len(self.plan)
        completed = 0
        stress_released = n_cal >= total
        now = 0.0
        while self._events and completed < total:
            now, _, kind, payload = heapq.heappop(self._events)
            # Sec. II-G: the stress burst is submitted once the
            # calibration phase has fully drained.
            if not stress_released and completed >= n_cal:
                stress_released = True
                self.phase_boundary = now
                for dt, req in self.plan.stress:
                    self._push(now + dt, "arrival", req)
            if kind == "telemetry":
                self._sample_telemetry(now)
                self._maybe_hedge(now)
                if completed < total:
                    self._push(now + cfg.telemetry_interval, "telemetry", None)
            else:
                completed += self.handle_event(now, kind, payload)

        busy = sum(w.busy_time for w in self.workers) / max(len(self.workers), 1)
        return summarize_run(
            self.sched.policy.name,
            self.sched.config.bias_enabled,
            self.sched.completed,
            busy_time=busy,
            n_failed_dispatches=self.n_failed_dispatches,
        )

    # --- composition introspection (used by repro.cluster) -------------
    def inflight_requests(self) -> List[Request]:
        out = [r for reqs in self._inflight.values() for r in reqs]
        for batch in self._batches.values():
            out.extend(s.req for s in batch.slots)
            out.extend(s.req for s in batch.finished)
        return out

    def n_busy_workers(self) -> int:
        return sum(1 for w in self.workers if w.alive and not w.idle)

    def n_alive_workers(self) -> int:
        return sum(1 for w in self.workers if w.alive)

    def is_idle(self) -> bool:
        return (not self._inflight and not self._batches
                and self.sched.queue_depth() == 0)

    def prefix_cached_tokens(self, req: Request) -> int:
        """Resident-prefix overlap this worker group holds for ``req``,
        in tokens (0 without a cache / a shareable prefix / for work
        whose KV already arrived via handoff). Pure probe: does not
        touch LRU or refcount state — the cluster router calls this for
        every routable replica on every placement."""
        if self.prefix_tree is None or req.handoff_time is not None:
            return 0
        key = prefix_page_key(req.prefix_group, req.shared_prefix_tokens,
                              self.cfg.prefix_page_tokens)
        if not key:
            return 0
        return min(self.prefix_tree.cached_tokens(key), req.prompt_tokens)

    def prefix_cache_stats(self) -> Dict[str, int]:
        """Cumulative cache counters (all zero when disabled)."""
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

    # ------------------------------------------------------------------
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
            # paper: wait batch_wait before dispatching a formed batch
            self._pending_batch_start[wid] = True
            self._push(now + self.cfg.batch_wait, "batch_start", wid)

    def _start_batch(self, wid: int, now: float) -> None:
        w = self.workers[wid]
        if not (w.alive and w.idle):
            return
        if self.cfg.step_engine:
            reqs = self.sched.dispatch_step(now, self.cfg.batch_capacity)
        else:
            reqs = self.sched.dispatch_batch(now, self.cfg.batch_capacity)
        if not reqs:
            return
        for r in reqs:
            r.state = RequestState.EXECUTING
            r.exec_start = now
            r.worker_id = wid
        if self.cfg.step_engine:
            self._start_step_batch(wid, reqs, now)
        else:
            self._run_batch(wid, reqs, now)
        self.sched.queues.record_depth(now)

    # --- atomic-batch execution (the paper's calibrated protocol) -------
    def _run_batch(self, wid: int, reqs: List[Request], now: float) -> None:
        w = self.workers[wid]
        w.idle = False
        jitter = self.cost.jitter(self.rng)
        t_exec = self.cost.batch_time(reqs, jitter=jitter)
        w.expected_exec = self.cost.batch_time(reqs, jitter=1.0)
        if w.slow:
            t_exec *= self.cfg.straggler_factor
        self._inflight[wid] = reqs
        w.exec_started = now
        w.hedged = False
        w.busy_until = now + t_exec
        w.busy_time += t_exec
        w.batches += 1
        self.heartbeats.beat(wid, now)
        self.stragglers.observe(wid, t_exec)
        self._push(now + t_exec, "batch_done", (wid, reqs, False))

    def _maybe_hedge(self, now: float) -> None:
        """Speculatively re-execute overdue batches on idle workers."""
        if not self.cfg.hedge:
            return
        if self._complete_hook is not None:
            # hedging relies on the COMPLETED-state guard to make the
            # losing copy a no-op; hook-intercepted requests never reach
            # COMPLETED here, so a hedge would fire the hook twice
            # (double handoff -> double feedback). Mutually exclusive.
            return
        idle = [i for i, w in enumerate(self.workers)
                if w.alive and w.idle]
        if not idle:
            return
        for wid, w in enumerate(self.workers):
            if w.idle or w.hedged or not w.alive:
                continue
            if wid not in self._inflight:
                continue
            overdue = (now - w.exec_started
                       > self.cfg.hedge_factor * max(w.expected_exec, 1e-6))
            if not overdue:
                continue
            spare = idle.pop(0)
            w.hedged = True
            self.n_hedges += 1
            # copy of the request list: each worker's inflight entry is
            # its own; first completion wins, the other is a no-op
            self._run_batch(spare, list(self._inflight[wid]), now)
            if not idle:
                break

    def _finish_batch(self, wid: int, reqs: List[Request],
                      aborted: bool, now: float) -> int:
        w = self.workers[wid]
        if self._inflight.get(wid) is not reqs:
            return 0  # stale event (batch was aborted by a failure)
        del self._inflight[wid]
        w.idle = True
        done = 0
        hedge_win = False
        for r in reqs:
            if r.state is RequestState.COMPLETED:
                continue               # the other copy won the hedge race
            if self._complete_hook is not None \
                    and self._complete_hook(r, now):
                continue               # owner intercepted (phase handoff)
            if r.worker_id != wid:
                hedge_win = True       # we are the speculative copy
            r.exec_end = now
            observed = min(r.true_output_tokens, r.max_tokens)
            self.sched.complete(r, observed, now)
            if self.trace.enabled:
                self.trace.emit(now, tr.COMPLETE, req_id=r.req_id,
                                rid=self.trace_rid,
                                tenant=r.tenant.label,
                                observed=observed, e2e=r.e2e_latency,
                                ttft=r.ttft,
                                inter_token=r.inter_token_latency)
            done += 1
        if hedge_win and done:
            self.n_hedge_wins += 1
        self.sched.queues.record_depth(now)
        return done

    # --- iteration-level execution (continuous batching) ----------------
    def _make_slot(self, req: Request, now: float) -> SlotProgress:
        """Slot state for a joining request. Work already prefilled
        elsewhere (its KV arrived via a P/D handoff) skips prefill;
        prefill-phase slots decode nothing (target 0) and retire at
        prefill completion. With a prefix cache, the resident full
        pages of the request's shared prefix are served from cache:
        prefill starts at the cached boundary and the matched tree
        path is locked against eviction until the slot retires."""
        prefill = 0 if req.handoff_time is not None else req.prompt_tokens
        slot = SlotProgress(
            req=req, prefill_remaining=prefill,
            target=(0 if self.cfg.phase == "prefill"
                    else min(req.true_output_tokens, req.max_tokens)))
        if self.prefix_tree is not None and prefill > 0:
            slot.prefix_key = prefix_page_key(
                req.prefix_group, req.shared_prefix_tokens,
                self.cfg.prefix_page_tokens)
            if slot.prefix_key:
                node, n_pages = self.prefix_tree.match(slot.prefix_key,
                                                       now)
                cached = min(n_pages * self.cfg.prefix_page_tokens,
                             prefill)
                if cached > 0:
                    self.prefix_tree.lock(node)
                    slot.prefix_node = node
                    slot.cached_tokens = cached
                    slot.prefill_remaining = prefill - cached
                    self.n_prefix_hits += 1
                    self.prefix_tokens_saved += cached
                    if self.trace.enabled:
                        self.trace.emit(now, tr.PREFIX_HIT,
                                        req_id=req.req_id,
                                        rid=self.trace_rid,
                                        tenant=req.tenant.label,
                                        tokens=cached)
                else:
                    self.n_prefix_misses += 1
                    if self.trace.enabled:
                        self.trace.emit(now, tr.PREFIX_MISS,
                                        req_id=req.req_id,
                                        rid=self.trace_rid,
                                        tenant=req.tenant.label)
        if req.handoff_time is None:
            # record the realized hit only where prefill actually runs:
            # a decode-phase slot must not wipe the prefill replica's
            # attribution before completion feeds the drift sample
            req.cached_prompt_tokens = slot.cached_tokens
        self.token_ledger[req.req_id] = [0, 0]
        self.prefix_ledger[req.req_id] = slot.cached_tokens
        return slot

    def _start_step_batch(self, wid: int, reqs: List[Request],
                          now: float) -> None:
        w = self.workers[wid]
        w.idle = False
        w.exec_started = now
        w.batches += 1
        batch = RunningBatch(slots=[self._make_slot(r, now) for r in reqs],
                             gen=next(self._gen))
        self._batches[wid] = batch
        self._schedule_step(wid, now, include_base=True)

    def _schedule_step(self, wid: int, now: float, *,
                       include_base: bool = False) -> None:
        """Precompute and schedule ONE iteration: apportion the per-step
        prefill chunk budget across prefilling slots in join order, mark
        which slots emit a decode token (a slot's prefill-completing
        iteration also emits its first token, like the JAX engine's
        prefill), and price it via :meth:`CostModel.step_time`."""
        w = self.workers[wid]
        batch = self._batches[wid]
        budget = self.cfg.chunk_prefill_tokens
        remaining = math.inf if budget is None else budget
        pending: List[Tuple[SlotProgress, int, bool]] = []
        n_emit = 0
        prefill_tokens = 0
        for slot in batch.slots:
            take = 0
            if slot.prefill_remaining > 0:
                take = int(min(slot.prefill_remaining, remaining))
                remaining -= take
                emits = (take == slot.prefill_remaining
                         and slot.target > 0)
            else:
                emits = slot.decode_done < slot.target
            pending.append((slot, take, emits))
            prefill_tokens += take
            n_emit += int(emits)
        batch.pending = pending
        dt = self.cost.step_time(
            n_emit, prefill_tokens, include_base=include_base,
            jitter=self.cost.jitter(self.rng))
        if w.slow:
            dt *= self.cfg.straggler_factor
        w.busy_until = now + dt
        w.busy_time += dt
        self.n_steps += 1
        self.heartbeats.beat(wid, now)
        self.stragglers.observe(wid, dt)
        self._push(now + dt, "step_done", (wid, batch.gen))

    def _release_prefix(self, slot: SlotProgress) -> None:
        """Drop the slot's pin on its cached prefix pages (retirement
        or takeover). After a failure-driven cache wipe the old node is
        orphaned and releasing it is a harmless no-op on dead state."""
        if slot.prefix_node is not None:
            self.prefix_tree.release(slot.prefix_node)
            slot.prefix_node = None

    def _on_slot_prefilled(self, slot: SlotProgress, now: float) -> None:
        """A slot's last prompt chunk just landed: its shareable full
        pages become resident for future requests (RadixAttention
        inserts at prefill completion). The pin moves from the matched
        prefix to the deepest inserted node so the whole resident run
        survives until this slot retires. Insertion may evict LRU
        unreferenced leaves (this is the iteration-boundary eviction
        point) and truncates under unrelievable pressure — caching is
        best-effort."""
        if self.prefix_tree is None or not slot.prefix_key:
            return
        evicted_before = self.prefix_tree.n_evicted_pages
        node, _ = self.prefix_tree.insert(slot.prefix_key, now)
        self._release_prefix(slot)
        self.prefix_tree.lock(node)
        slot.prefix_node = node
        if self.trace.enabled:
            delta = self.prefix_tree.n_evicted_pages - evicted_before
            if delta > 0:
                self.trace.emit(now, tr.PREFIX_EVICT, rid=self.trace_rid,
                                pages=delta)

    def _complete_step_request(self, slot: SlotProgress, now: float) -> int:
        """Retire one finished slot: stamp timestamps and run the normal
        completion path unless the owner's hook intercepts (P/D prefill
        handoff). Returns 1 when a completion was produced."""
        req = slot.req
        self._release_prefix(slot)
        if self._complete_hook is not None and self._complete_hook(req, now):
            return 0
        req.exec_end = now
        self.sched.complete(req, slot.decode_done, now)
        if self.trace.enabled:
            self.trace.emit(now, tr.COMPLETE, req_id=req.req_id,
                            rid=self.trace_rid, tenant=req.tenant.label,
                            observed=slot.decode_done, e2e=req.e2e_latency,
                            ttft=req.ttft,
                            inter_token=req.inter_token_latency)
        return 1

    def _finish_step(self, wid: int, gen: int, now: float) -> int:
        """One iteration boundary: apply the precomputed progress, stamp
        TTFT on slots whose first token just landed, retire finished
        slots (immediately with mid-flight joins; held to batch drain in
        the atomic/parity contract), then refill free slots and schedule
        the next iteration."""
        w = self.workers[wid]
        batch = self._batches.get(wid)
        if batch is None or batch.gen != gen or not w.alive:
            return 0                       # stale event (aborted batch)
        done = 0
        still: List[SlotProgress] = []
        tron = self.trace.enabled
        for slot, take, emits in batch.pending:
            ledger = self.token_ledger[slot.req.req_id]
            if take:
                slot.prefill_remaining -= take
                ledger[0] += take
                if tron:
                    self.trace.emit(now, tr.PREFILL_CHUNK,
                                    req_id=slot.req.req_id,
                                    rid=self.trace_rid,
                                    tenant=slot.req.tenant.label,
                                    tokens=take)
                if slot.prefill_remaining <= 0:
                    self._on_slot_prefilled(slot, now)
            if emits:
                slot.decode_done += 1
                ledger[1] += 1
                if slot.decode_done == 1 and slot.req.prefill_end is None:
                    # first token observed at this iteration's end: the
                    # honest unified-replica TTFT anchor
                    slot.req.prefill_end = now
                    if tron:
                        self.trace.emit(
                            now, tr.FIRST_TOKEN,
                            req_id=slot.req.req_id, rid=self.trace_rid,
                            tenant=slot.req.tenant.label,
                            ttft=now - slot.req.arrival_time)
                elif tron:
                    self.trace.emit(now, tr.DECODE_STEP,
                                    req_id=slot.req.req_id,
                                    rid=self.trace_rid,
                                    n=slot.decode_done)
            finished = (slot.prefill_remaining <= 0
                        and slot.decode_done >= slot.target)
            if not finished:
                still.append(slot)
            elif self.cfg.continuous_joins:
                done += self._complete_step_request(slot, now)
            else:
                batch.finished.append(slot)
        batch.slots = still
        batch.pending = []

        if self.cfg.continuous_joins and batch.slots:
            free = self.cfg.batch_capacity - len(batch.slots)
            if free > 0 and self.sched.queue_depth() > 0:
                joined = self.sched.dispatch_step(now, free)
                for r in joined:
                    r.state = RequestState.EXECUTING
                    r.exec_start = now
                    r.worker_id = wid
                    batch.slots.append(self._make_slot(r, now))
                if joined:
                    self.n_joins += len(joined)
                    self.sched.queues.record_depth(now)

        if batch.slots:
            self._schedule_step(wid, now)
        else:
            # batch drained: flush held retirements (atomic contract —
            # everyone completes at batch end, matching batch_time)
            for slot in batch.finished:
                done += self._complete_step_request(slot, now)
            del self._batches[wid]
            w.idle = True
            w.busy_until = now
        if done:
            self.sched.queues.record_depth(now)
        return done

    # ------------------------------------------------------------------
    def _fail_worker(self, wid: int, now: float) -> None:
        w = self.workers[wid]
        if not w.alive:
            return
        w.alive = False
        w.idle = False
        reqs = self._inflight.pop(wid, [])
        batch = self._batches.pop(wid, None)
        if batch is not None:
            # iteration-boundary preemption: members that already
            # retired stay completed; unfinished slots (and retirements
            # held for the atomic drain) re-queue from scratch
            reqs = [s.req for s in batch.slots] \
                + [s.req for s in batch.finished]
        if self.prefix_tree is not None:
            # the KV pool died with the worker: every resident prefix —
            # and every lock held by the aborted slots — is gone. A
            # retry anywhere re-probes/re-prefills from scratch (lost
            # KV → full re-prefill; the at-most-once feedback contract
            # is untouched because aborted work never fed back).
            self.prefix_tree.clear()
            self.n_cache_invalidations += 1
        if self.trace.enabled:
            self.trace.emit(now, tr.WORKER_FAIL, rid=self.trace_rid,
                            wid=wid, n_requeued=len(reqs))
        # abort: un-spend the remaining busy time, re-queue the requests
        if reqs:
            w.busy_time -= max(w.busy_until - now, 0.0)
            for r in reqs:
                if self.trace.enabled:
                    self.trace.emit(now, tr.PREEMPT, req_id=r.req_id,
                                    rid=self.trace_rid,
                                    tenant=r.tenant.label,
                                    reason="worker_fail")
                if r.handoff_time is None:
                    # partial unified/prefill progress dies with the
                    # worker; clear the TTFT stamp so a retry re-anchors
                    # it (handed-off decode work keeps its prefill_end:
                    # that phase really did finish elsewhere)
                    r.prefill_end = None
                self.token_ledger.pop(r.req_id, None)
                self.prefix_ledger.pop(r.req_id, None)
                self.sched.fail(r, now)
                self.n_failed_dispatches += 1
        self._push(now + self.cfg.repair_time, "repair", wid)
        self.sched.queues.record_depth(now)

    # ------------------------------------------------------------------
    def _slot_kv_pages(self) -> int:
        """Pages materialised in the KV pool right now, rounded PER
        SLOT exactly as ``kv_cache.PagedAllocator`` allocates (page
        granularity is per sequence, not over the aggregate token sum).
        Step engine: exact per-slot progress (prefilled + decoded —
        this is what makes memory telemetry respond to chunked
        prefill); cache-served prefix tokens are excluded here (their
        pages are shared — the prefix tree reports them once, see
        :meth:`_sample_telemetry`). Atomic mode: the batch's full
        reservation (prompt + planned output), the vLLM-style upper
        bound an atomic batch allocates up front."""
        pages = 0
        for batch in self._batches.values():
            for slot in itertools.chain(batch.slots, batch.finished):
                tokens = (slot.req.prompt_tokens - slot.cached_tokens
                          - slot.prefill_remaining + slot.decode_done)
                if tokens > 0:
                    pages += _pages_needed(tokens)
        for reqs in self._inflight.values():
            for r in reqs:
                pages += _pages_needed(
                    r.prompt_tokens + min(r.true_output_tokens,
                                          r.max_tokens))
        return pages

    def _sample_telemetry(self, now: float) -> None:
        active = sum(len(v) for v in self._inflight.values()) \
            + sum(len(b.slots) + len(b.finished)
                  for b in self._batches.values())
        busy_now = sum(1 for w in self.workers if not w.idle and w.alive)
        alive = max(sum(1 for w in self.workers if w.alive), 1)
        # memory: preallocated plateau + workspace scaled by paged-KV
        # pool occupancy (see the telemetry memory model notes above)
        # each worker models one GPU with its own reserved pool of
        # batch_capacity x max-context pages; occupancy is fleet-wide
        # used pages over the fleet-wide pool
        pool_pages = (len(self.workers) * self.cfg.batch_capacity
                      * _pages_needed(KV_MAX_CONTEXT_TOKENS))
        used_pages = self._slot_kv_pages() if busy_now else 0
        if self.prefix_tree is not None and self.prefix_tree.total_pages():
            # resident shared prefixes occupy pool pages whether or not
            # any batch is running — that is the point of the cache.
            # Tree pages are prefix_page_tokens-sized (configurable);
            # convert to the fixed KV_PAGE_TOKENS telemetry granularity
            # so occupancy units agree.
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
        if self.trace.enabled:
            rid = self.trace_rid
            self.trace.emit(now, tr.GAUGE, rid=rid, name="queue_depth",
                            value=self.sched.queue_depth())
            self.trace.emit(now, tr.GAUGE, rid=rid,
                            name="active_requests", value=active)
            self.trace.emit(now, tr.GAUGE, rid=rid, name="kv_free_pages",
                            value=max(pool_pages - used_pages, 0))
            for tier, depth in self.sched.queues.depths().items():
                self.trace.emit(now, tr.GAUGE, rid=rid,
                                name=f"queue_{tier.label}", value=depth)


def make_worker_simulator(scheduler: DriftScheduler,
                          plan: Optional[ArrivalPlan] = None,
                          config: Optional[SimConfig] = None,
                          cost_model: Optional[CostModel] = None,
                          sink: Optional[Callable[[float, str, object],
                                                  None]] = None,
                          rng: Optional[random.Random] = None,
                          complete_hook: Optional[
                              Callable[[Request, float], bool]] = None,
                          trace=None):
    """Backend-dispatching constructor for worker-group simulators.

    ``SimConfig.backend`` picks the executor:

    * ``"object"`` — :class:`WorkerSimulator` (the event-heap oracle).
    * ``"vector"`` — the flat-array core: sink-driven (cluster)
      replicas get :class:`StepVectorizedWorkerSimulator`, standalone
      runs get :class:`VectorWorkerSimulator` built from the
      scheduler's configuration. Never silently falls back — vector
      construction either returns a vector class or raises.
    """
    cfg = config or SimConfig()
    if cfg.backend == "object":
        return WorkerSimulator(scheduler, plan, cfg, cost_model,
                               sink=sink, rng=rng,
                               complete_hook=complete_hook, trace=trace)
    if cfg.backend != "vector":
        raise ValueError(
            f"unknown SimConfig.backend {cfg.backend!r} "
            "(expected 'object' or 'vector')")
    from .vector_sim import (StepVectorizedWorkerSimulator,
                             VectorWorkerSimulator)
    if sink is not None:
        return StepVectorizedWorkerSimulator(
            scheduler, plan, cfg, cost_model, sink=sink, rng=rng,
            complete_hook=complete_hook, trace=trace)
    if complete_hook is not None:
        raise ValueError(
            "backend='vector' standalone runs do not support "
            "complete_hook (P/D handoff is an object-engine feature)")
    return VectorWorkerSimulator.from_scheduler(
        scheduler, plan, config=cfg, cost_model=cost_model, rng=rng)


def __getattr__(name: str):
    # Deliberately ImportError, not AttributeError: the tombstone must
    # surface its migration pointer on the common breakage path
    # (`from repro.serving.simulator import ClusterSimulator`), where an
    # AttributeError would be swallowed and replaced by the generic
    # "cannot import name" message. The cost — hasattr/getattr probes
    # for the removed alias fail loudly instead of returning False — is
    # intended: nothing should feature-detect a pre-cluster-layer alias.
    if name == "ClusterSimulator":
        raise ImportError(
            "repro.serving.simulator.ClusterSimulator was a pre-cluster-"
            "layer alias of WorkerSimulator and has been removed. Use "
            "repro.cluster.ClusterSimulator for the N-replica cluster "
            "simulator, or repro.serving.WorkerSimulator for a single "
            "replica.")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
