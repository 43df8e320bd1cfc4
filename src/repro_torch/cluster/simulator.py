"""Cluster-level discrete-event simulator: N replicas, one event loop.

Composes N per-replica :class:`~repro.serving.simulator.WorkerSimulator`
instances (each driving its own :class:`DriftScheduler`, all sharing
one :class:`AdaptiveTokenEstimator`) under a single event heap and a
single seed:

    arrival -> GlobalAdmission (rate limits, backpressure; shed or pass)
            -> ClusterRouter   (round_robin / least_loaded /
                                drift_aware / tenant_affinity /
                                prefix_aware / pd_disaggregated)
            -> replica's DriftScheduler -> replica workers

With ``ClusterConfig.prefix_cache=True`` (step engine required) every
replica models a radix shared-prefix KV cache: placement stamps the
chosen replica's resident-prefix overlap into
``Request.expected_cached_tokens`` (the admission estimate prices only
the uncached suffix), prefill starts at the cached boundary, and
``prefix_aware`` routing scores replicas by measured residency. A
replica failure wipes that replica's cache along with its KV pool —
stranded work re-prefills in full wherever it lands.

Under ``pd_disaggregated`` routing the lifecycle is two-stage: the
request prefills on a PREFILL-role replica, its KV moves to a
DECODE-role replica via a modeled transfer delay, and decode completes
there (drift feedback fires once, attributed to the decode phase).
Optional work stealing lets idle replicas take queued work from
overloaded role-compatible peers at every control tick.

Replica events (batch_start/batch_done/step_done/fail/repair) emitted
by a replica's simulator are routed back through the shared heap via
the sink mechanism, so cross-replica ordering is exact and
deterministic. With ``ClusterConfig.step_engine=True`` every replica
runs the iteration-level continuous-batching engine
(``serving.simulator`` module docstring): unified replicas report
honest per-request TTFT (first decoded token, not batch end), P/D
prefill handoffs fire the moment a prompt's last chunk lands rather
than at batch drain, and preemption/work-stealing observe replica state
at iteration boundaries.

Fault injection composes with the per-worker story: a replica failure
aborts its in-flight batches (re-queued with estimates preserved, no
bias feedback — the at-most-once contract), then the cluster drains the
failed replica's queue and *reroutes* the stranded requests to the
surviving replicas. The replica rejoins the routable pool when its
workers repair.

The optional :class:`Autoscaler` runs at every control tick: scale-up
provisions a fresh replica (cold start delay before it serves; its
scheduler shares the cluster estimator so it is calibration-warm from
its first request), scale-down marks the least-loaded replica DRAINING
(finishes its backlog, takes no new work, then leaves the pool).
"""

from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.estimator import AdaptiveTokenEstimator, DriftConfig
from ..core.request import Request
from ..core.scheduler import DriftScheduler
from ..obs import events as tr
from ..obs import resolve_recorder
from ..serving.cost_model import (CostModel, L4_QWEN_1_8B, decode_view,
                                  prefill_view)
from ..serving.simulator import (SimConfig, WorkerSimulator,
                                 make_worker_simulator)
from ..workload.generator import ArrivalPlan
from .admission import AdmissionConfig, GlobalAdmission
from .autoscaler import (SCALE_DOWN, SCALE_UP, Autoscaler, RoleAutoscaler)
from .metrics import ClusterMetrics, summarize_cluster
from .replica import Replica, ReplicaRole, ReplicaState
from .router import ClusterRouter, RoutingPolicy


@dataclass(frozen=True)
class ClusterConfig:
    """Cluster topology + protocol knobs. Times in seconds, masses in
    estimated budget tokens (Eq. 1), counts in requests/replicas."""

    n_replicas: int = 4
    workers_per_replica: int = 1
    routing: str = "drift_aware"
    scheduler_policy: str = "fifo"
    batch_capacity: int = 32          # per replica (paper Sec. III-B)
    batch_wait: float = 0.01
    # --- iteration-level execution core (serving.simulator docstring):
    # step_engine=False keeps the calibrated atomic-batch pricing; True
    # runs every replica on the continuous-batching step engine —
    # unified replicas then report honest per-request TTFT, and P/D
    # handoffs / preemption / work stealing land at iteration
    # boundaries. chunk_prefill_tokens budgets prefill tokens per
    # iteration (None = unbounded); continuous_joins=False degenerates
    # to the atomic/parity contract; max_new_per_step caps slot
    # admissions per iteration (DriftScheduler.dispatch_step).
    step_engine: bool = False
    chunk_prefill_tokens: Optional[int] = None
    continuous_joins: bool = True
    max_new_per_step: Optional[int] = None
    # --- execution-core backend (serving.vector_sim): "object" keeps
    # the per-Request step engine; "vector" provisions every replica as
    # a StepVectorizedWorkerSimulator, which epoch-batches full
    # pure-decode batches between cluster-visible events (requires
    # step_engine; incompatible with pd_disaggregated, whose prefill
    # replicas need per-request completion hooks).
    backend: str = "object"
    # --- shared-prefix KV cache (radix tree per replica; requires
    # step_engine). Replicas skip prefilling resident full pages of a
    # request's shared prompt prefix; `prefix_aware` routing scores
    # replicas by that residency; the router stamps the chosen
    # replica's overlap into Request.expected_cached_tokens so the
    # admission estimate prices only the uncached suffix. Replica
    # failure invalidates the replica's whole cache (KV dies with it).
    prefix_cache: bool = False
    prefix_cache_pages: int = 4096
    prefix_page_tokens: int = 128     # shareable-page granularity (tokens)
    control_interval: float = 1.0     # autoscaler / telemetry cadence
    max_time: float = 1e6             # hard stop against pathological stalls
    # replica-level fault injection: (absolute time, replica id)
    fail_events: Tuple[Tuple[float, int], ...] = ()
    repair_time: float = 30.0
    seed: int = 0
    # --- P/D disaggregation (active when routing == "pd_disaggregated")
    # explicit prefill-pool size; None derives it from the fraction
    n_prefill_replicas: Optional[int] = None
    pd_prefill_fraction: float = 0.25     # prefill share of the pool
    # modeled KV-transfer time for one handoff:
    #   kv_transfer_base + kv_transfer_per_token * prompt_tokens  (s)
    # ~PCIe/NVLink-era page migration: ms-scale, prompt-length driven
    kv_transfer_base: float = 0.002
    kv_transfer_per_token: float = 2e-5
    # --- cross-replica work stealing (any routing mode)
    work_stealing: bool = False
    steal_min_depth: int = 4          # victim queue depth before stealing


@dataclass
class Handoff:
    """One prefill→decode KV transfer in flight.

    Departs the source (prefill) replica when its prefill batch
    finishes; arrives ``kv_transfer`` seconds later, at which point the
    decode replica is chosen and the request enqueued there. If the
    source replica fails before arrival the KV is lost and the request
    re-runs prefill (``cancelled`` marks the dead transfer).
    ``forced_dst_rid`` pins the destination (work stealing re-transfers
    KV to a specific thief)."""

    req: Request
    src_rid: int
    forced_dst_rid: Optional[int] = None
    stolen: bool = False           # this transfer carries stolen work
    cancelled: bool = False


class SimReplica(Replica):
    """Replica backed by an externally-driven WorkerSimulator."""

    def __init__(self, rid: int, scheduler: DriftScheduler,
                 sim: WorkerSimulator,
                 role: ReplicaRole = ReplicaRole.UNIFIED) -> None:
        super().__init__(rid, scheduler, role=role)
        self.sim = sim

    def inflight_requests(self) -> List[Request]:
        """Requests executing on this replica's workers right now."""
        return self.sim.inflight_requests()

    def busy_workers(self) -> int:
        """Workers mid-batch (numerator of the utilization signal)."""
        return self.sim.n_busy_workers()

    def alive_workers(self) -> int:
        """Non-failed workers (denominator of the utilization signal)."""
        return self.sim.n_alive_workers()

    def is_idle(self) -> bool:
        """True when nothing is queued or in flight here."""
        return self.sim.is_idle()

    def prefix_cached_tokens(self, req: Request) -> int:
        """Resident shared-prefix overlap in this replica's KV cache
        (pure probe — see the base class contract)."""
        return self.sim.prefix_cached_tokens(req)

    def prefix_cache_stats(self) -> dict:
        return self.sim.prefix_cache_stats()

    def accept(self, req: Request, now: float) -> None:
        """Admit a routed request (full admission path: estimate, log,
        enqueue) and kick dispatch."""
        self.sim.handle_event(now, "arrival", req)

    def accept_reroute(self, req: Request, now: float) -> None:
        """Take over a request stranded on a failed replica. The
        original estimate and enqueue timestamp travel with it (no
        re-estimation, no new admission record, no bias feedback) —
        the cluster analogue of the head-of-queue readmit contract."""
        self.sched.queues.enqueue(req, req.enqueue_time, front=True)
        self.sim.handle_event(now, "kick", None)

    def accept_handoff(self, req: Request, now: float, *,
                       record: bool = True) -> None:
        """Receive a prefilled request whose KV transfer just landed
        (P/D path, stage 2). Joins the back of its tenant queue with the
        original enqueue timestamp (FIFO ordering stays admission-
        ordered); the admission estimate travels untouched — decode
        placement already consumed it, and bias feedback fires only at
        decode completion. ``record=False`` skips the ``n_handoffs_in``
        credit (stolen re-transfers count under the steal counters
        instead, keeping handoff in/out conservation exact)."""
        if record:
            self.n_handoffs_in += 1
        self.sched.queues.enqueue(req, req.enqueue_time)
        self.sim.handle_event(now, "kick", None)

    def accept_steal(self, req: Request, now: float) -> None:
        """Receive a queued request stolen from an overloaded peer.
        Estimate and enqueue timestamp preserved (stealing must not
        re-price or re-order work it moves)."""
        self.n_stolen_in += 1
        self.sched.queues.enqueue(req, req.enqueue_time)
        self.sim.handle_event(now, "kick", None)


@dataclass
class ClusterTelemetry:
    """One control-tick sample: active/starting replica counts, total
    queued estimated-token mass (Eq. 1), busy/alive utilization."""

    time: float
    n_active: int
    n_starting: int
    queue_mass: float
    utilization: float


class ClusterSimulator:
    """One event loop over N replicas, a router, and a front door.

    With ``routing="pd_disaggregated"`` the pool is role-split and the
    request lifecycle becomes the two-stage pipeline::

        admit -> prefill replica -> (KV transfer) -> decode replica
              -> complete (drift feedback, attributed to "decode")

    With ``work_stealing=True`` idle replicas additionally steal half
    the queue of their most-backlogged role-compatible peer at every
    control tick (decode-ready work pays a fresh KV transfer).
    """

    def __init__(self, plan: ArrivalPlan,
                 config: Optional[ClusterConfig] = None,
                 cost_model: Optional[CostModel] = None,
                 drift_config: Optional[DriftConfig] = None,
                 admission: Optional[GlobalAdmission] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 routing: Optional[RoutingPolicy] = None,
                 trace=None) -> None:
        self.plan = plan
        self.cfg = config or ClusterConfig()
        self.cost = cost_model or L4_QWEN_1_8B
        self.rng = random.Random(self.cfg.seed)   # one seed, shared
        self.estimator = AdaptiveTokenEstimator(drift_config or DriftConfig())
        self.admission = admission
        self.autoscaler = autoscaler
        self.trace = resolve_recorder(trace)
        if self.trace.enabled:
            # the front door and the control plane emit into the same
            # recorder the replicas use (cluster-scope events: rid=None)
            if admission is not None:
                admission.trace = self.trace
            if autoscaler is not None:
                autoscaler.trace = self.trace
        self._arrived: set = set()     # req_ids already ARRIVE-traced
        self.router = ClusterRouter(routing or self.cfg.routing,
                                    self.estimator, trace=self.trace)
        self.pd_mode = self.router.policy.name == "pd_disaggregated"
        if self.cfg.backend == "vector" and self.pd_mode:
            raise ValueError(
                "ClusterConfig.backend='vector' is incompatible with "
                "pd_disaggregated routing: prefill replicas complete "
                "through per-request hooks the vectorized core does "
                "not expose. Use backend='object' for P/D runs.")
        self.replicas: List[SimReplica] = []
        self.telemetry: List[ClusterTelemetry] = []
        self.n_rerouted = 0
        self.n_handoffs = 0            # prefill→decode transfers initiated
        self.n_handoffs_lost = 0       # transfers cancelled by src failure
        self.n_stolen = 0              # requests moved by work stealing
        self.completed_total = 0
        self.phase_boundary = 0.0
        self._in_transit: Dict[int, Handoff] = {}   # req_id -> live handoff
        self._events: List[tuple] = []
        self._eseq = itertools.count()
        self._rid_seq = itertools.count()
        roles = self._initial_roles()
        # the pool shape actually built — handed to a RoleAutoscaler
        # whose config leaves target_prefill_fraction unset, so scaling
        # never fights a non-default initial split
        self._pd_target_fraction: Optional[float] = (
            roles.count(ReplicaRole.PREFILL) / len(roles)
            if self.pd_mode else None)
        for role in roles:
            self._provision_replica(ReplicaState.ACTIVE, role)

    def _initial_roles(self) -> List[ReplicaRole]:
        """Pool shape at t=0: all UNIFIED, or the P/D split (at least
        one prefill and one decode replica; prefill replicas get the
        low rids)."""
        n = self.cfg.n_replicas
        if not self.pd_mode:
            return [ReplicaRole.UNIFIED] * n
        if n < 2:
            raise ValueError("pd_disaggregated needs >= 2 replicas "
                             "(one prefill + one decode)")
        n_prefill = self.cfg.n_prefill_replicas
        if n_prefill is None:
            n_prefill = round(n * self.cfg.pd_prefill_fraction)
        n_prefill = min(max(n_prefill, 1), n - 1)
        return ([ReplicaRole.PREFILL] * n_prefill
                + [ReplicaRole.DECODE] * (n - n_prefill))

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: str, payload=None) -> None:
        heapq.heappush(self._events, (t, next(self._eseq), kind, payload))

    def _provision_replica(self, state: ReplicaState,
                           role: ReplicaRole = ReplicaRole.UNIFIED
                           ) -> SimReplica:
        """Create one replica (shared estimator, shared heap, shared
        seed) with a phase-scoped cost model and completion behaviour
        matching its role: prefill replicas hand finished prefills off
        instead of completing them; decode replicas attribute drift
        feedback to the "decode" phase."""
        rid = next(self._rid_seq)
        sched = DriftScheduler(policy=self.cfg.scheduler_policy,
                               estimator=self.estimator,
                               max_new_per_step=self.cfg.max_new_per_step)
        cost = self.cost
        hook = None
        phase = "unified"
        if role is ReplicaRole.PREFILL:
            cost = prefill_view(self.cost)
            phase = "prefill"
            hook = (lambda req, now, rid=rid:
                    self._on_prefill_done(rid, req, now))
        elif role is ReplicaRole.DECODE:
            cost = decode_view(self.cost)
            phase = "decode"
            sched.feedback_phase = "decode"
        sim = make_worker_simulator(
            sched,
            config=SimConfig(
                batch_capacity=self.cfg.batch_capacity,
                batch_wait=self.cfg.batch_wait,
                n_workers=self.cfg.workers_per_replica,
                step_engine=self.cfg.step_engine,
                chunk_prefill_tokens=self.cfg.chunk_prefill_tokens,
                continuous_joins=self.cfg.continuous_joins,
                prefix_cache=self.cfg.prefix_cache,
                prefix_cache_pages=self.cfg.prefix_cache_pages,
                prefix_page_tokens=self.cfg.prefix_page_tokens,
                phase=phase,
                repair_time=self.cfg.repair_time,
                backend=self.cfg.backend,
                seed=self.cfg.seed),
            cost_model=cost,
            sink=lambda t, kind, payload, rid=rid:
                self._push(t, "replica", (rid, kind, payload)),
            rng=self.rng,
            complete_hook=hook,
            trace=self.trace)
        sim.trace_rid = rid
        sched.drift.trace_rid = rid
        rep = SimReplica(rid, sched, sim, role=role)
        rep.state = state
        self.replicas.append(rep)
        return rep

    # ------------------------------------------------------------------
    def _n_shed(self) -> int:
        return self.admission.n_shed() if self.admission else 0

    def _processed(self) -> int:
        return self.completed_total + self._n_shed()

    def cluster_token_mass(self) -> float:
        """Outstanding estimated work (Eq. 1 budgets) across the whole
        cluster: queued + executing on live replicas, plus requests
        whose KV is mid-transfer between prefill and decode replicas
        (they are nowhere else, but their work is still owed)."""
        from .replica import _budget
        return (sum(r.token_mass() for r in self.replicas
                    if r.state is not ReplicaState.STOPPED)
                + sum(_budget(h.req) for h in self._in_transit.values()))

    # ------------------------------------------------------------------
    def run(self) -> ClusterMetrics:
        """Drive the whole cluster to completion (every request
        completed or shed, or ``max_time`` reached) and summarize."""
        cfg = self.cfg
        n_start = cfg.n_replicas
        n_cal = len(self.plan.calibration)
        total = len(self.plan)
        if self.trace.enabled:
            self.trace.begin_segment(
                f"cluster:{self.router.policy.name}"
                f"/{cfg.scheduler_policy}"
                f"{':step' if cfg.step_engine else ''}")
        for t, req in self.plan.calibration:
            self._push(t, "arrival", req)
        for ft, rid in cfg.fail_events:
            self._push(ft, "replica_fail", rid)
        self._push(0.0, "control", None)

        stress_released = n_cal >= total
        now = 0.0
        while self._events and self._processed() < total:
            now, _, kind, payload = heapq.heappop(self._events)
            if now > cfg.max_time:
                break
            # Sec. II-G protocol at cluster scope: release the stress
            # burst once the calibration phase has fully drained
            # (completed or shed — shed requests never complete).
            if not stress_released and self._processed() >= n_cal:
                stress_released = True
                self.phase_boundary = now
                for dt, req in self.plan.stress:
                    self._push(now + dt, "arrival", req)
            if kind == "arrival":
                self._on_arrival(payload, now)
            elif kind == "replica":
                rid, rkind, rpayload = payload
                self._on_replica_event(rid, rkind, rpayload, now)
            elif kind == "handoff":
                self._on_handoff(payload, now)
            elif kind == "replica_fail":
                self._fail_replica(payload, now)
            elif kind == "replica_ready":
                rep = self.replicas[payload]
                if rep.state is ReplicaState.STARTING:
                    rep.state = ReplicaState.ACTIVE
            elif kind == "control":
                self._control(now)
                if self._processed() < total:
                    self._push(now + cfg.control_interval, "control", None)
        return self._summarize(n_start)

    # ------------------------------------------------------------------
    def _on_arrival(self, req: Request, now: float) -> None:
        est = self.router.price(req)
        if self.trace.enabled and req.req_id not in self._arrived:
            # park-retries re-enter this handler: trace ARRIVE once
            self._arrived.add(req.req_id)
            self.trace.emit(now, tr.ARRIVE, req_id=req.req_id,
                            tenant=req.tenant.label, est_budget=est)
        if self.admission is not None:
            ok, _ = self.admission.offer(req, est, now,
                                         self.cluster_token_mass())
            if not ok:
                return
        target = self.router.route(self.replicas, req, now, est_budget=est)
        if target is None:
            if self.admission is None:
                # no front door to account the shed: park until the
                # pool recovers by retrying shortly
                self._push(now + 1.0, "arrival", req)
            else:
                self.admission.shed_no_replica(req, est, now)
            return
        if self.trace.enabled and self.admission is None:
            # no front door: placement is the admission decision
            self.trace.emit(now, tr.ADMIT, req_id=req.req_id,
                            tenant=req.tenant.label, est_budget=est)
        # the chosen replica's resident-prefix overlap prices the
        # admission estimate: only the uncached suffix is budgeted
        # (0 without a prefix cache — the estimate is then unchanged)
        req.expected_cached_tokens = target.prefix_cached_tokens(req)
        target.accept(req, now)

    def _on_replica_event(self, rid: int, rkind: str, rpayload,
                          now: float) -> None:
        """Forward one replica-emitted event (batch_start / batch_done /
        step_done / fail / repair / kick) back into its WorkerSimulator
        and count any completions it produced. Prefill-phase finishes
        are intercepted by the completion hook and never count here."""
        rep = self.replicas[rid]
        if rkind == "repair" and rep.state is ReplicaState.FAILED:
            rep.state = ReplicaState.ACTIVE
            if self.trace.enabled:
                self.trace.emit(now, tr.REPLICA_RECOVER, rid=rid)
        self.completed_total += rep.sim.handle_event(now, rkind, rpayload)

    # --- P/D two-stage lifecycle ---------------------------------------
    def _on_prefill_done(self, rid: int, req: Request, now: float) -> bool:
        """Completion hook on prefill replicas: the request's *prefill
        phase* finished (batch end on the atomic path; the iteration its
        last prompt chunk landed on the step engine) — stamp TTFT, start
        the modeled KV transfer, and tell the WorkerSimulator the
        request was taken over (no ``sched.complete``, so no drift
        feedback: the prefill phase observes no output length)."""
        req.prefill_end = now
        req.prefill_rid = rid
        rep = self.replicas[rid]
        rep.n_handoffs_out += 1
        self.n_handoffs += 1
        if self.trace.enabled:
            # P/D TTFT anchor: the prompt's last token landed here
            self.trace.emit(now, tr.FIRST_TOKEN, req_id=req.req_id,
                            rid=rid, tenant=req.tenant.label,
                            ttft=now - req.arrival_time)
            self.trace.emit(now, tr.HANDOFF, req_id=req.req_id,
                            rid=rid, tenant=req.tenant.label,
                            edge="out")
        h = Handoff(req=req, src_rid=rid)
        self._in_transit[req.req_id] = h
        self._push(now + self._kv_delay(req), "handoff", h)
        return True

    def _kv_delay(self, req: Request) -> float:
        """Modeled KV-transfer time (s): base link cost + per-prompt-
        token page movement."""
        return (self.cfg.kv_transfer_base
                + self.cfg.kv_transfer_per_token * req.prompt_tokens)

    def _on_handoff(self, h: Handoff, now: float) -> None:
        """A KV transfer arrived: place the prefilled request on a
        decode replica. Cancelled transfers (source replica died in
        flight — KV lost) were already rerouted by the failure path.
        A stolen transfer is pinned to its thief when still routable;
        with no decode-capable replica up, the KV waits at the source
        and retries."""
        if h.cancelled:
            return
        self._in_transit.pop(h.req.req_id, None)
        dst: Optional[Replica] = None
        if h.forced_dst_rid is not None:
            cand = self.replicas[h.forced_dst_rid]
            if cand.routable():
                dst = cand
        if dst is None:
            dst = self.router.route_decode(self.replicas, h.req, now)
        if dst is None:
            # no decode-capable replica routable: KV stays at the
            # source; retry while the pool recovers (source failure
            # meanwhile cancels the handoff and forces re-prefill)
            self._in_transit[h.req.req_id] = h
            self._push(now + 1.0, "handoff", h)
            return
        h.req.handoff_time = now
        h.req.decode_rid = dst.rid
        if h.stolen:
            dst.n_stolen_in += 1   # credited where the work landed
        if self.trace.enabled:
            self.trace.emit(now, tr.HANDOFF, req_id=h.req.req_id,
                            rid=dst.rid, tenant=h.req.tenant.label,
                            edge="in", src_rid=h.src_rid,
                            stolen=h.stolen)
        dst.accept_handoff(h.req, now, record=not h.stolen)

    # --- work stealing -------------------------------------------------
    def _run_steals(self, now: float) -> None:
        """Execute the router's steal plans: move the tail (coldest,
        lowest-tier end — ``TenantQueueManager.drain`` yields premium
        first) of each victim's queue to its idle thief. Not-yet-
        prefilled work moves instantly; decode-ready work pays a fresh
        KV transfer from the victim (the pages live there)."""
        for plan in self.router.plan_steals(
                self.replicas, now, min_victim_depth=self.cfg.steal_min_depth):
            victim = self.replicas[plan.victim_rid]
            thief = self.replicas[plan.thief_rid]
            queued = victim.sched.queues.drain()
            if plan.req_ids:
                # residency-vetoed plan: move exactly the pinned set
                # (tail members whose cache discount did not outweigh
                # the imbalance gain)
                chosen = set(plan.req_ids)
                keep = [r for r in queued if r.req_id not in chosen]
                stolen = [r for r in queued if r.req_id in chosen]
            else:
                keep, stolen = queued[:len(queued) - plan.n], \
                    queued[len(queued) - plan.n:]
            for req in keep:
                victim.sched.queues.enqueue(req, req.enqueue_time)
            for req in stolen:
                req.n_steals += 1
                victim.n_stolen_away += 1
                self.n_stolen += 1
                if self.trace.enabled:
                    self.trace.emit(now, tr.STEAL, req_id=req.req_id,
                                    rid=thief.rid,
                                    tenant=req.tenant.label,
                                    victim=victim.rid,
                                    decode_ready=req.prefill_end
                                    is not None)
                if req.prefill_end is not None:
                    # decode-ready: the KV re-transfers from the victim;
                    # n_stolen_in is credited at delivery (the planned
                    # thief may become unroutable mid-transfer)
                    h = Handoff(req=req, src_rid=victim.rid,
                                forced_dst_rid=thief.rid, stolen=True)
                    self._in_transit[req.req_id] = h
                    self._push(now + self._kv_delay(req), "handoff", h)
                else:
                    thief.accept_steal(req, now)

    # --- failure handling ----------------------------------------------
    def _fail_replica(self, rid: int, now: float) -> None:
        """Role-aware replica failure.

        1. In-flight batches abort (estimates preserved, no bias
           feedback — the at-most-once contract) and land back at the
           head of the replica's own queue.
        2. KV transfers *sourced* at the dead replica are lost: those
           requests re-run prefill elsewhere (estimate kept, feedback
           never fired, so nothing double-counts).
        3. The stranded queue reroutes to surviving replicas. Work that
           had already prefilled lost its KV with the replica, so it
           resets to the pre-prefill state and rejoins via stage-1
           routing (prefill-capable pool under P/D).
        """
        rep = self.replicas[rid]
        if rep.state in (ReplicaState.STOPPED, ReplicaState.FAILED):
            return
        rep.state = ReplicaState.FAILED
        if self.trace.enabled:
            self.trace.emit(now, tr.REPLICA_FAIL, rid=rid,
                            role=rep.role.value)
        # (2) cancel in-transit handoffs whose KV source died
        for h in [h for h in self._in_transit.values()
                  if h.src_rid == rid]:
            h.cancelled = True
            del self._in_transit[h.req.req_id]
            self.n_handoffs_lost += 1
            if h.stolen:
                # an undelivered steal never happened: unwind the
                # take-side accounting so the flow counters balance
                h.req.n_steals -= 1
                rep.n_stolen_away -= 1
                self.n_stolen -= 1
            h.req.reset_for_reprefill()
            self._reroute_stranded(rep, h.req, now)
        # (1) abort in-flight batches
        for wid in range(len(rep.sim.workers)):
            rep.sim.handle_event(now, "fail", wid)
        # (3) reroute the whole stranded queue to surviving replicas
        stranded = rep.sched.queues.drain()
        for req in reversed(stranded):      # front-pushes: keep order
            if req.prefill_end is not None:
                req.reset_for_reprefill()   # KV died with the replica
            self._reroute_stranded(rep, req, now)

    def _reroute_stranded(self, rep: SimReplica, req: Request,
                          now: float) -> None:
        """Route one stranded request off ``rep``; with the whole pool
        down it parks on the failed replica and is served after
        repair.

        The admission estimate travels with the request (no re-pricing
        of its bias-derived parts — the at-most-once contract), but the
        *cache discount* inside it belonged to the dead replica's
        residency, which no longer exists: restore the full-prompt
        budget, then re-discount by the surviving replica's own
        resident overlap. A re-prefill is priced where it will actually
        run."""
        est = req.estimate
        if est is not None and est.cached_tokens:
            est.t_budget += est.cached_tokens
            est.cached_tokens = 0
            req.expected_cached_tokens = 0
        target = self.router.route(self.replicas, req, now, exclude=(rep,))
        if target is None:
            rep.sched.queues.enqueue(req, req.enqueue_time, front=True)
            return
        if est is not None:
            overlap = target.prefix_cached_tokens(req)
            if overlap:
                est.t_budget -= overlap
                est.cached_tokens = overlap
                req.expected_cached_tokens = overlap
        rep.n_rerouted_away += 1
        self.n_rerouted += 1
        target.accept_reroute(req, now)

    def _control(self, now: float) -> None:
        """Control-plane tick (every ``control_interval`` s): finish
        draining replicas, run work stealing, then let the autoscaler
        act (role-aware when a :class:`RoleAutoscaler` drives a P/D
        pool)."""
        for rep in self.replicas:
            if rep.state is ReplicaState.DRAINING and rep.is_idle():
                rep.state = ReplicaState.STOPPED
        if self.cfg.work_stealing:
            self._run_steals(now)
        if self.autoscaler is not None:
            self._autoscale(now)
        mass, util, n_active = Autoscaler.signals(self.replicas)
        self.telemetry.append(ClusterTelemetry(
            time=now, n_active=n_active,
            n_starting=sum(1 for r in self.replicas
                           if r.state is ReplicaState.STARTING),
            queue_mass=mass, utilization=util))
        if self.trace.enabled:
            self.trace.emit(now, tr.GAUGE, name="cluster_queue_mass",
                            value=mass)
            self.trace.emit(now, tr.GAUGE, name="cluster_utilization",
                            value=util)
            self.trace.emit(now, tr.GAUGE, name="active_replicas",
                            value=n_active)

    def _autoscale(self, now: float) -> None:
        """One autoscaler decision. A RoleAutoscaler on a P/D pool
        scales each role pool separately; otherwise whole-pool scaling
        (new replicas join as DECODE in P/D mode — the larger,
        output-length-bound pool — and UNIFIED elsewhere)."""
        starting = [r for r in self.replicas
                    if r.state is ReplicaState.STARTING]
        if self.pd_mode and isinstance(self.autoscaler, RoleAutoscaler):
            by_role: Dict[ReplicaRole, int] = {}
            for r in starting:
                by_role[r.role] = by_role.get(r.role, 0) + 1
            decision = self.autoscaler.decide_role(
                now, self.replicas, by_role,
                default_target=self._pd_target_fraction)
            if decision is None:
                return
            action, role = decision
            if action == SCALE_UP:
                rep = self._provision_replica(ReplicaState.STARTING, role)
                self._push(now + self.autoscaler.cfg.startup_delay,
                           "replica_ready", rep.rid)
            else:
                target = self.autoscaler.pick_drain_target(self.replicas,
                                                           role=role)
                if target is not None:
                    target.state = ReplicaState.DRAINING
            return
        action = self.autoscaler.decide(now, self.replicas, len(starting))
        if action == SCALE_UP:
            role = (ReplicaRole.DECODE if self.pd_mode
                    else ReplicaRole.UNIFIED)
            rep = self._provision_replica(ReplicaState.STARTING, role)
            self._push(now + self.autoscaler.cfg.startup_delay,
                       "replica_ready", rep.rid)
        elif action == SCALE_DOWN:
            target = self.autoscaler.pick_drain_target(self.replicas)
            if target is not None and not self._last_of_role(target):
                target.state = ReplicaState.DRAINING

    def _last_of_role(self, target: SimReplica) -> bool:
        """In P/D mode a role pool must never drain to zero: losing the
        last prefill replica would silently degrade stage-1 routing to
        the decode-pool fallback (prompt cost unmodeled, no handoffs)
        for the rest of the run. RoleAutoscaler guards this itself;
        this check protects the plain-Autoscaler path."""
        if not self.pd_mode:
            return False
        return sum(1 for r in self.replicas
                   if r.state is ReplicaState.ACTIVE
                   and r.role is target.role) <= 1

    # ------------------------------------------------------------------
    def _summarize(self, n_start: int) -> ClusterMetrics:
        """Collect completions across replicas (stable completion-time
        order) and aggregate into :class:`ClusterMetrics`."""
        completed: List[Request] = []
        busy: Dict[int, float] = {}
        done: Dict[int, int] = {}
        n_failed = 0
        for rep in self.replicas:
            completed.extend(rep.sched.completed)
            busy[rep.rid] = (sum(w.busy_time for w in rep.sim.workers)
                             / max(len(rep.sim.workers), 1))
            done[rep.rid] = len(rep.sched.completed)
            n_failed += rep.sim.n_failed_dispatches
        completed.sort(key=lambda r: (r.completion_time, r.req_id))
        return summarize_cluster(
            self.router.policy.name, self.cfg.scheduler_policy,
            self.estimator.config.bias_enabled, completed,
            replicas=self.replicas, admission=self.admission,
            autoscaler=self.autoscaler, n_replicas_start=n_start,
            replica_busy_time=busy, replica_completed=done,
            n_failed_dispatches=n_failed, n_rerouted=self.n_rerouted,
            n_handoffs=self.n_handoffs, n_handoffs_lost=self.n_handoffs_lost,
            n_stolen=self.n_stolen, backend=self.cfg.backend)
