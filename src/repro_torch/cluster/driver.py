"""Cluster driver over real :class:`ServingEngine` instances.

The same :class:`ClusterRouter` / :class:`GlobalAdmission` front end
that drives the discrete-event cluster simulator, run over N live port
continuous-batching engines — the execution-agnostic contract
:class:`DriftScheduler` already honors, lifted one level up. Each
engine owns its own scheduler; all schedulers share one
:class:`AdaptiveTokenEstimator`, so drift feedback from any replica
calibrates routing and admission for the whole cluster.

P/D disaggregation runs for real here: under ``pd_disaggregated``
routing the pool splits into prefill and decode engines, and a
finished prefill *moves its KV pages* — the slot's page contents are
gathered off the source engine's :class:`PagedPool`, carried by a
:class:`KVTransfer` for the modeled link delay, and scattered into
freshly allocated pages on the decode engine (see
``ServingEngine.extract_sequence`` / ``accept_handoff``). The driver
keeps the transfer ledger (``_in_transit``) and mirrors the
simulator's failure contract: transfers sourced at a dead engine are
lost and their requests re-run prefill elsewhere; stranded prefilled
queue entries reset to the pre-prefill state because their pages died
with the pool. Work stealing moves queued work between engines, with
decode-ready steals paying a fresh KV transfer from the victim.

Oracle-EOS caveat (see ``serving/engine.py``): with randomly
initialised smoke models the engines stop each request at its
ground-truth output length rather than a semantic EOS token. Cluster
runs inherit this — observed lengths (and therefore the drift feedback
that routing quality depends on) are the planted ground truth, not
model behaviour. A real deployment swaps in token-id EOS detection per
engine; nothing at the cluster layer changes.

Stepping model: engines advance in lockstep rounds (every engine steps
once per simulated ``dt``); due KV transfers deliver at the start of
each round. There is no cross-engine batching — a request lives on
exactly one replica at a time, as in the simulator.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..core.estimator import AdaptiveTokenEstimator, DriftConfig
from ..core.request import Request
from ..core.scheduler import DriftScheduler
from ..obs import events as tr
from ..obs import resolve_recorder
from ..serving.engine import EngineConfig, ServingEngine
from ..serving.metrics import RunMetrics, summarize_run
from .admission import GlobalAdmission
from .replica import Replica, ReplicaRole, ReplicaState
from .router import ClusterRouter, RoutingPolicy


@dataclass
class KVTransfer:
    """One prefill→decode KV movement in flight between engines.

    ``payload`` is the actual page contents (host copies of the source
    pool's K/V pages plus decode-resume scalars) — not a token count.
    ``forced_dst_rid`` pins a stolen transfer to its thief;
    ``cancelled`` marks a transfer whose source engine died before
    delivery (the KV is lost — the failure path already rerouted the
    request for re-prefill)."""

    req: Request
    src_rid: int
    payload: Dict
    arrive_time: float
    forced_dst_rid: Optional[int] = None
    stolen: bool = False
    cancelled: bool = False


class EngineReplica(Replica):
    """Replica backed by a live ServingEngine."""

    def __init__(self, rid: int, engine: ServingEngine,
                 role: ReplicaRole = ReplicaRole.UNIFIED) -> None:
        super().__init__(rid, engine.sched, role=role)
        self.engine = engine

    def inflight_requests(self) -> List[Request]:
        """Requests currently occupying live decode slots."""
        return [s.req for s in self.engine.slots if s.req is not None]

    def busy_workers(self) -> int:
        """1 when any decode slot is active (the engine is one
        worker), else 0 — the cluster utilization numerator."""
        return 1 if self.engine.active_slots() else 0

    def is_idle(self) -> bool:
        """True when nothing is queued or decoding on this engine."""
        return self.queue_depth() == 0 and not self.engine.active_slots()

    def prefix_cached_tokens(self, req: Request) -> int:
        """Resident shared-prefix overlap in this engine's radix KV
        cache (``EngineConfig.prefix_cache``) — the *measured* warmth
        signal ``prefix_aware`` routing scores over real engines. Pure
        probe, like the simulator replica's."""
        return self.engine.prefix_cached_tokens(req)

    def prefix_cache_stats(self) -> dict:
        return self.engine.prefix_cache_stats()


class EngineClusterDriver:
    """Route + admit over N live engines, step them in lockstep.

    Under ``pd_disaggregated`` routing the driver also owns the P/D
    control plane: role assignment (prefill engines get the low rids,
    same as the simulator), the handoff hook on every prefill engine,
    the in-flight KV-transfer ledger, role-aware failure recovery, and
    optional work stealing."""

    def __init__(self, engines: Sequence[ServingEngine],
                 routing: str | RoutingPolicy = "drift_aware",
                 admission: Optional[GlobalAdmission] = None,
                 trace=None, *,
                 n_prefill_replicas: Optional[int] = None,
                 pd_prefill_fraction: float = 0.25,
                 kv_transfer_base: float = 0.002,
                 kv_transfer_per_token: float = 2e-5,
                 work_stealing: bool = False,
                 steal_min_depth: int = 4) -> None:
        if not engines:
            raise ValueError("need at least one engine")
        stores = {id(e.sched.estimator.bias_store) for e in engines}
        if len(stores) != 1:
            raise ValueError(
                "cluster engines must share one AdaptiveTokenEstimator "
                "(build schedulers with DriftScheduler(estimator=shared)); "
                f"got {len(stores)} distinct bias stores")
        self.estimator = engines[0].sched.estimator
        self.trace = resolve_recorder(trace)
        self.router = ClusterRouter(routing, self.estimator,
                                    trace=self.trace)
        self.pd_mode = self.router.policy.name == "pd_disaggregated"
        roles = (self._initial_roles(len(engines), n_prefill_replicas,
                                     pd_prefill_fraction)
                 if self.pd_mode
                 else [ReplicaRole.UNIFIED] * len(engines))
        if self.pd_mode:
            not_paged = [i for i, e in enumerate(engines)
                         if not e.ecfg.paged]
            if not_paged:
                raise ValueError(
                    "engine-side pd_disaggregated moves real KV pages, so "
                    "every engine needs the paged pool "
                    f"(EngineConfig.paged=True); engines {not_paged} are "
                    "not paged")
        self.replicas = [EngineReplica(i, e, role=r)
                         for i, (e, r) in enumerate(zip(engines, roles))]
        if self.trace.enabled:
            # stamp replica ids onto the engines' emissions (only when
            # live — never stomp an explicitly un-traced engine)
            if admission is not None:
                admission.trace = self.trace
            for rep in self.replicas:
                rep.engine.trace = self.trace
                rep.engine.trace_rid = rep.rid
                rep.engine.sched.drift.trace = self.trace
                rep.engine.sched.drift.trace_rid = rep.rid
        for rep in self.replicas:
            if rep.role is ReplicaRole.PREFILL:
                rep.engine.handoff_hook = (
                    lambda slot, req, now, rid=rep.rid:
                    self._on_prefill_done(rid, slot, req, now))
            elif rep.role is ReplicaRole.DECODE:
                # decode replicas attribute drift feedback to the
                # decode phase (phase-scoped bias, same as the sim)
                rep.engine.sched.feedback_phase = "decode"
        self.admission = admission
        self.kv_transfer_base = kv_transfer_base
        self.kv_transfer_per_token = kv_transfer_per_token
        self.work_stealing = work_stealing
        self.steal_min_depth = steal_min_depth
        self._in_transit: Dict[int, KVTransfer] = {}
        self._transfer_heap: List = []
        self._tseq = itertools.count()
        self.n_shed = 0
        self.n_handoffs = 0
        self.n_handoffs_lost = 0
        self.n_stolen = 0
        self.n_rerouted = 0
        self._last_submit = 0.0

    @staticmethod
    def _initial_roles(n: int, n_prefill: Optional[int],
                       fraction: float) -> List[ReplicaRole]:
        """P/D pool shape at t=0: at least one prefill and one decode
        engine; prefill engines get the low rids. Mirrors
        ``ClusterSimulator._initial_roles``."""
        if n < 2:
            raise ValueError("pd_disaggregated needs >= 2 replicas "
                             "(one prefill + one decode)")
        if n_prefill is None:
            n_prefill = round(n * fraction)
        n_prefill = min(max(n_prefill, 1), n - 1)
        return ([ReplicaRole.PREFILL] * n_prefill
                + [ReplicaRole.DECODE] * (n - n_prefill))

    # ------------------------------------------------------------------
    def submit(self, req: Request, now: float) -> bool:
        """Front door: returns False when the request was shed."""
        self._last_submit = max(self._last_submit, now)
        est = self.router.price(req)
        if self.trace.enabled:
            self.trace.emit(now, tr.ARRIVE, req_id=req.req_id,
                            tenant=req.tenant.label, est_budget=est)
        if self.admission is not None:
            mass = sum(r.token_mass() for r in self.replicas)
            ok, _ = self.admission.offer(req, est, now, mass)
            if not ok:
                self.n_shed += 1
                return False
        target = self.router.route(self.replicas, req, now, est_budget=est)
        if target is None:
            if self.admission is not None:
                self.admission.shed_no_replica(req, est, now)
            elif self.trace.enabled:
                # no front door to account (and trace) the shed
                self.trace.emit(now, tr.SHED, req_id=req.req_id,
                                tenant=req.tenant.label,
                                reason="no_replica", est_budget=est)
            self.n_shed += 1
            return False
        if self.trace.enabled and self.admission is None:
            # no front door: placement is the admission decision
            self.trace.emit(now, tr.ADMIT, req_id=req.req_id,
                            tenant=req.tenant.label, est_budget=est)
        # the chosen engine's resident-prefix overlap prices the
        # admission estimate (estimate(cached_tokens=...) discounts
        # T_input only; 0 without a prefix cache) — fed from an actual
        # tree lookup, same contract as the cluster simulator
        req.expected_cached_tokens = target.prefix_cached_tokens(req)
        target.sched.submit(req, now)
        return True

    # --- P/D handoff: real KV page movement ---------------------------
    def _kv_delay(self, req: Request) -> float:
        """Modeled KV-transfer time (s): base link cost + per-prompt-
        token page movement. The *contents* move for real; only the
        wire time is modeled."""
        return (self.kv_transfer_base
                + self.kv_transfer_per_token * req.prompt_tokens)

    def _on_prefill_done(self, rid: int, slot: int, req: Request,
                         now: float) -> bool:
        """Handoff hook on prefill engines, called by the engine the
        moment a slot's last prompt chunk lands (its first token
        exists; TTFT was just stamped): snapshot the slot's KV pages
        off the pool, start the transfer, and return True so the
        engine releases the slot without completing the request (no
        ``sched.complete`` → no drift feedback here — the at-most-once
        contract; the decode engine observes the full output)."""
        rep = self.replicas[rid]
        payload = rep.engine.extract_sequence(slot)
        req.prefill_rid = rid
        rep.n_handoffs_out += 1
        self.n_handoffs += 1
        if self.trace.enabled:
            self.trace.emit(now, tr.HANDOFF, req_id=req.req_id,
                            rid=rid, tenant=req.tenant.label,
                            edge="out")
        t = KVTransfer(req=req, src_rid=rid, payload=payload,
                       arrive_time=now + self._kv_delay(req))
        self._queue_transfer(t)
        return True

    def _queue_transfer(self, t: KVTransfer) -> None:
        self._in_transit[t.req.req_id] = t
        heapq.heappush(self._transfer_heap,
                       (t.arrive_time, next(self._tseq), t))

    def _deliver_transfers(self, now: float) -> None:
        """Land every due KV transfer on a decode engine. A stolen
        transfer is pinned to its thief while the thief is routable;
        with no decode-capable engine up, the KV waits and retries
        (source failure meanwhile cancels it and forces re-prefill)."""
        while self._transfer_heap and self._transfer_heap[0][0] <= now:
            _, _, t = heapq.heappop(self._transfer_heap)
            if t.cancelled:
                continue
            self._in_transit.pop(t.req.req_id, None)
            dst: Optional[EngineReplica] = None
            if t.forced_dst_rid is not None:
                cand = self.replicas[t.forced_dst_rid]
                if cand.routable():
                    dst = cand
            if dst is None:
                dst = self.router.route_decode(self.replicas, t.req, now)
            if dst is None:
                t.arrive_time = now + 1.0
                self._queue_transfer(t)
                continue
            t.req.handoff_time = now
            t.req.decode_rid = dst.rid
            if t.stolen:
                dst.n_stolen_in += 1   # credited where the work landed
            else:
                dst.n_handoffs_in += 1
            if self.trace.enabled:
                self.trace.emit(now, tr.HANDOFF, req_id=t.req.req_id,
                                rid=dst.rid, tenant=t.req.tenant.label,
                                edge="in", src_rid=t.src_rid,
                                stolen=t.stolen)
            dst.engine.accept_handoff(t.req, t.payload)

    # --- work stealing -------------------------------------------------
    def _run_steals(self, now: float) -> None:
        """Execute the router's steal plans over live engines.
        Not-yet-prefilled work moves instantly (it carries no state);
        decode-ready work detaches its pending KV payload from the
        victim engine and re-transfers it to the thief (the pages live
        on the victim — a steal is a second page movement)."""
        for plan in self.router.plan_steals(
                self.replicas, now, min_victim_depth=self.steal_min_depth):
            victim = self.replicas[plan.victim_rid]
            thief = self.replicas[plan.thief_rid]
            queued = victim.sched.queues.drain()
            if plan.req_ids:
                chosen = set(plan.req_ids)
                keep = [r for r in queued if r.req_id not in chosen]
                stolen = [r for r in queued if r.req_id in chosen]
            else:
                keep, stolen = (queued[:len(queued) - plan.n],
                                queued[len(queued) - plan.n:])
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
                payload = victim.engine.pop_pending_injection(req.req_id)
                if payload is not None:
                    # decode-ready: the KV re-transfers from the victim;
                    # n_stolen_in is credited at delivery (the planned
                    # thief may become unroutable mid-transfer)
                    self._queue_transfer(KVTransfer(
                        req=req, src_rid=victim.rid, payload=payload,
                        arrive_time=now + self._kv_delay(req),
                        forced_dst_rid=thief.rid, stolen=True))
                else:
                    thief.n_stolen_in += 1
                    thief.sched.queues.enqueue(req, req.enqueue_time)

    # --- failure handling ----------------------------------------------
    def fail_replica(self, rid: int, now: float) -> None:
        """Role-aware engine failure; the simulator's contract over
        real pools.

        1. KV transfers *sourced* at the dead engine are lost — the
           pages existed only in the payload and the dead pool: those
           requests reset to the pre-prefill state and re-run prefill
           elsewhere (estimate kept; feedback never fired, so nothing
           double-counts).
        2. In-flight slots abort (``ServingEngine.abort_all`` frees the
           pages and drops pending injections).
        3. The stranded queue reroutes to surviving engines. Work that
           had already prefilled lost its KV with the pool, so it
           resets and rejoins via stage-1 routing (prefill-capable
           pool under P/D).
        """
        rep = self.replicas[rid]
        if rep.state in (ReplicaState.STOPPED, ReplicaState.FAILED):
            return
        rep.state = ReplicaState.FAILED
        if self.trace.enabled:
            self.trace.emit(now, tr.REPLICA_FAIL, rid=rid,
                            role=rep.role.value)
        # (1) cancel in-transit transfers whose KV source died
        for t in [t for t in self._in_transit.values()
                  if t.src_rid == rid]:
            t.cancelled = True
            del self._in_transit[t.req.req_id]
            self.n_handoffs_lost += 1
            if t.stolen:
                # an undelivered steal never happened: unwind the
                # take-side accounting so the flow counters balance
                t.req.n_steals -= 1
                rep.n_stolen_away -= 1
                self.n_stolen -= 1
            t.req.reset_for_reprefill()
            self._reroute_stranded(rep, t.req, now)
        # (2) abort in-flight slots
        inflight = rep.engine.abort_all(now)
        for req in inflight:
            if req.prefill_end is not None:
                req.reset_for_reprefill()   # KV died with the pool
            else:
                req.reset_for_retry()
        # (3) reroute the whole stranded queue to surviving engines
        stranded = rep.sched.queues.drain()
        for req in stranded:
            if req.prefill_end is not None:
                req.reset_for_reprefill()
        for req in reversed(inflight + stranded):   # front-pushes: keep order
            self._reroute_stranded(rep, req, now)

    def _reroute_stranded(self, rep: EngineReplica, req: Request,
                          now: float) -> None:
        """Route one stranded request off ``rep``; with the whole pool
        down it parks on the failed engine and is served after
        recovery. The admission estimate travels with the request, but
        its *cache discount* belonged to the dead engine's residency:
        restore the full-prompt budget, then re-discount by the
        surviving engine's own resident overlap."""
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
        target.sched.queues.enqueue(req, req.enqueue_time, front=True)

    def recover_replica(self, rid: int, now: float) -> None:
        """Bring a failed engine back (empty pool, cold caches — the
        engine's state died with the failure and ``abort_all`` already
        reset it)."""
        rep = self.replicas[rid]
        if rep.state is not ReplicaState.FAILED:
            return
        rep.state = ReplicaState.ACTIVE
        if self.trace.enabled:
            self.trace.emit(now, tr.REPLICA_RECOVER, rid=rid,
                            role=rep.role.value)

    # ------------------------------------------------------------------
    def step(self, now: float) -> int:
        """One lockstep round across all replicas; returns completions.
        Due KV transfers land first so a decode engine can dispatch
        them this very round, then engines step, then idle engines
        steal from backlogged peers."""
        self._deliver_transfers(now)
        done = sum(rep.engine.step(now) for rep in self.replicas
                   if rep.routable())
        if self.work_stealing:
            self._run_steals(now)
        return done

    def _drained(self) -> bool:
        return (all(rep.is_idle() for rep in self.replicas)
                and not self._in_transit)

    def run_until_drained(self, *, max_steps: int = 100_000,
                          dt: float = 1.0) -> RunMetrics:
        """Step every engine in lockstep (``dt`` simulated seconds per
        round) until the whole pool is idle — queues, slots, *and* the
        KV-transfer ledger — or ``max_steps`` rounds pass, then
        aggregate the familiar RunMetrics."""
        # start the clock at the latest submit time so completion
        # timestamps never precede arrivals (negative e2e latencies)
        now = self._last_submit
        if self.trace.enabled:
            self.trace.begin_segment(
                f"engine_cluster:{self.router.policy.name}"
                f"/{self.replicas[0].sched.policy.name}")
        for _ in range(max_steps):
            if self._drained():
                break
            self.step(now)
            now += dt
        completed: List[Request] = []
        busy = 0.0
        for rep in self.replicas:
            completed.extend(rep.sched.completed)
            busy += float(rep.engine.busy_steps) * dt
        completed.sort(key=lambda r: (r.completion_time, r.req_id))
        return summarize_run(
            self.replicas[0].sched.policy.name,
            self.estimator.config.bias_enabled,
            completed, busy_time=busy / len(self.replicas))


def make_engine_cluster(model_cfg, params, n_replicas: int, *,
                        policy: str = "fifo",
                        routing: str | RoutingPolicy = "drift_aware",
                        engine_config: Optional[EngineConfig] = None,
                        drift_config: Optional[DriftConfig] = None,
                        admission: Optional[GlobalAdmission] = None,
                        trace=None,
                        n_prefill_replicas: Optional[int] = None,
                        pd_prefill_fraction: float = 0.25,
                        kv_transfer_base: float = 0.002,
                        kv_transfer_per_token: float = 2e-5,
                        work_stealing: bool = False,
                        steal_min_depth: int = 4,
                        device: "str | torch.device" = "cuda",
                        ) -> EngineClusterDriver:
    """Convenience constructor: N engines over one model's params (the
    common deployment — replicas are copies of the same model), all
    schedulers sharing one estimator, every engine on ``device``."""
    estimator = AdaptiveTokenEstimator(drift_config or DriftConfig())
    engines = [
        ServingEngine(model_cfg, params,
                      DriftScheduler(policy=policy, estimator=estimator),
                      engine_config, device=device)
        for _ in range(n_replicas)
    ]
    return EngineClusterDriver(
        engines, routing=routing, admission=admission, trace=trace,
        n_prefill_replicas=n_prefill_replicas,
        pd_prefill_fraction=pd_prefill_fraction,
        kv_transfer_base=kv_transfer_base,
        kv_transfer_per_token=kv_transfer_per_token,
        work_stealing=work_stealing, steal_min_depth=steal_min_depth)
