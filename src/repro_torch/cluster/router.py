"""Cluster router: which replica serves which request.

Four pluggable routing policies over the :class:`Replica` introspection
surface:

* ``round_robin``     — cycle over routable replicas, load-blind.
* ``least_loaded``    — smallest outstanding estimated-token mass
  (queued + in-flight, Eq. 1 budgets).
* ``drift_aware``     — size-band packing from the calibrated budget
  distribution: each replica owns a contiguous band of the service-
  weighted size distribution, so heavy and light jobs land on different
  replicas and batches stay homogeneous. Batch execution walks to its
  longest member (cost model ``c_decode_max``), so homogeneous batches
  shorten every batch — the cluster-level analogue of SJF's win, and it
  sharpens as the shared estimator's drift compensation converges. A
  load-aware spill keeps the policy work-conserving.
* ``tenant_affinity`` — keeps a tenant's stream on its warm replica
  (stable tenant -> replica mapping), spilling to the least-loaded
  replica when the warm one is overloaded.
* ``prefix_aware``    — scores replicas by *measured* resident-prefix
  overlap (tokens of the request's shared prompt prefix already in the
  replica's radix KV cache — the thing that actually makes a replica
  warm), seeding cold prefix groups onto a stable group ring and
  spilling to least-loaded under imbalance. See
  :class:`PrefixAwareRouting`.
* ``pd_disaggregated`` — two-stage prefill/decode placement over a
  role-split pool: new requests go to prefill replicas (by prompt-token
  load), prefilled requests hand off to decode replicas (by estimated
  budget-token mass) via a modeled KV transfer. See
  :class:`PDDisaggregatedRouting`.

The router also owns the cross-replica *work-stealing* protocol
(:meth:`ClusterRouter.plan_steals`): idle replicas take half the queue
of their most-backlogged role-compatible peer, estimates preserved.

Selection is deterministic: replicas are scanned in ``rid`` order and
ties break toward the lowest ``rid``.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.admission import count_tokens
from ..core.estimator import AdaptiveTokenEstimator
from ..core.request import Request
from ..obs import events as tr
from ..obs import resolve_recorder
from .replica import Replica, ReplicaRole, ReplicaState, _budget


class RoutingPolicy:
    """Base class. Subclasses override :meth:`select`."""

    name: str = "base"

    def select(self, replicas: Sequence[Replica], req: Request,
               est_budget: float, now: float) -> Replica:
        """Pick one replica from a non-empty routable pool.

        ``est_budget`` is the request's estimated token budget (Eq. 1,
        prompt + calibrated output estimate from the shared estimator);
        ``now`` is the simulated/wall-clock time in seconds.
        """
        raise NotImplementedError


class RoundRobinRouting(RoutingPolicy):
    """Cycle over routable replicas (membership-change tolerant: the
    cursor indexes the current routable list, not absolute rids)."""

    name = "round_robin"

    def __init__(self) -> None:
        self._cursor = 0

    def select(self, replicas, req, est_budget, now):
        """Next replica in rotation; ignores the estimate entirely."""
        chosen = replicas[self._cursor % len(replicas)]
        self._cursor = (self._cursor + 1) % max(len(replicas), 1)
        return chosen


class LeastLoadedRouting(RoutingPolicy):
    """Smallest outstanding estimated-token mass wins."""

    name = "least_loaded"

    def select(self, replicas, req, est_budget, now):
        """Replica with the least outstanding estimated budget-token
        mass (Eq. 1, queued + in flight); ties to the lowest rid."""
        return min(replicas, key=lambda r: (r.token_mass(), r.rid))


class DriftAwareRouting(RoutingPolicy):
    """Service-weighted size-band packing with load-aware spill.

    Two calibrated signals, both in estimated-token units (Eq. 1):

    1. **Band placement.** The router maintains an online histogram of
       *service weight* — ``overhead_tokens + est_budget``, the token-
       equivalent cost of one request including its per-request batch
       overhead share — over log-spaced size buckets. A request's
       position in the service-weighted CDF maps it onto the replica
       ring: replica 0 serves the lightest band, replica n-1 the
       heaviest, and each band carries an (approximately) equal share
       of predicted service time. Homogeneous bands mean homogeneous
       batches, which cuts the walk-to-longest-member cost every batch
       pays under continuous batching.
    2. **Spill.** Band placement alone is open-loop; arrival noise can
       pile one band up while another drains. When the preferred
       replica's outstanding service load exceeds ``spill_factor`` x
       the minimum load plus ``spill_slack``, the request spills to
       the least-loaded replica instead — work-conserving by
       construction.

    Both signals improve as the shared estimator's bias converges: the
    CDF sharpens and the load measure tracks true occupancy. Defaults
    are calibrated for the L4 cost models (``overhead_tokens`` ~
    ``t_base / c_decode_max``).
    """

    name = "drift_aware"

    #: histogram domain: log2-spaced buckets over [16, 4096] est tokens
    _LOG_LO, _LOG_HI = 4.0, 12.0

    def __init__(self, overhead_tokens: float = 70.0,
                 spill_factor: float = 1.5,
                 spill_slack: float = 4000.0,
                 n_buckets: int = 64) -> None:
        self.overhead_tokens = float(overhead_tokens)
        self.spill_factor = float(spill_factor)
        self.spill_slack = float(spill_slack)
        self.n_buckets = int(n_buckets)
        self._weight = [0.0] * self.n_buckets

    def _bucket(self, est: float) -> int:
        x = max(est, 2.0 ** self._LOG_LO)
        frac = (math.log2(x) - self._LOG_LO) / (self._LOG_HI - self._LOG_LO)
        return min(max(int(frac * self.n_buckets), 0), self.n_buckets - 1)

    def _service_load(self, r: Replica) -> float:
        """Outstanding predicted service time, in service-weight units."""
        k = self.overhead_tokens
        return sum(k + _budget(q) for q in r.queued_requests()) \
            + sum(k + _budget(q) for q in r.inflight_requests())

    def select(self, replicas, req, est_budget, now):
        """Band placement from the service-weighted CDF position of
        ``est_budget`` (Eq. 1 tokens), with least-loaded spill when the
        preferred band replica is overloaded."""
        b = self._bucket(est_budget)
        below = sum(self._weight[:b + 1])
        total = sum(self._weight)
        if req.estimate is None:
            # first routing of this request: record it in the size CDF.
            # Rerouted requests carry their admission estimate and are
            # already counted — re-adding would skew the bands toward
            # whatever a failed replica happened to hold.
            self._weight[b] += self.overhead_tokens + est_budget
        q = below / total if total > 0 else 0.5
        n = len(replicas)
        pref = replicas[min(int(q * n), n - 1)]
        loads = {r.rid: self._service_load(r) for r in replicas}
        if loads[pref.rid] > (self.spill_factor * min(loads.values())
                              + self.spill_slack):
            return min(replicas, key=lambda r: (loads[r.rid], r.rid))
        return pref


class TenantAffinityRouting(RoutingPolicy):
    """Stable tenant -> replica mapping with load spill.

    A tenant's requests land on its *warm* replica (continuous-batching
    engines reuse compiled shapes / KV pages for a tenant's recurring
    traffic) unless that replica's mass exceeds ``spill_factor`` times
    the routable mean, in which case the request spills to the
    least-loaded replica.
    """

    name = "tenant_affinity"

    def __init__(self, spill_factor: float = 1.5) -> None:
        self.spill_factor = float(spill_factor)

    def select(self, replicas, req, est_budget, now):
        """Warm replica for the request's tenant unless its mass
        (Eq. 1 tokens) exceeds ``spill_factor`` x the routable mean."""
        # ring mapping on stable rids (not pool indices): the warm
        # replica of every other tenant survives membership changes —
        # a failed replica only remaps the tenants it was warming
        target = int(req.tenant)
        warm = next((r for r in replicas if r.rid >= target), replicas[0])
        mean_mass = sum(r.token_mass() for r in replicas) / len(replicas)
        if warm.token_mass() <= self.spill_factor * max(mean_mass, 1.0):
            return warm
        return min(replicas, key=lambda r: (r.token_mass(), r.rid))


class PrefixAwareRouting(RoutingPolicy):
    """Shared-prefix KV-reuse routing: follow the resident pages.

    ``tenant_affinity`` models warmth as stickiness; this policy
    measures it. Each replica exposes
    :meth:`~repro.cluster.replica.Replica.prefix_cached_tokens` — the
    tokens of the request's shared prompt prefix already resident in
    its radix KV cache (``ClusterConfig.prefix_cache``) — and placement
    follows three rules, in order:

    1. **Follow residency.** The replica with the largest resident
       overlap wins (ties to the lowest rid): every overlapping token
       is prefill work the cluster never re-pays, and the admission
       estimate prices the request's uncached suffix accordingly
       (``Request.expected_cached_tokens``, stamped by the cluster
       simulator at placement).
    2. **Seed cold groups deterministically.** A prefix group nobody
       holds yet maps onto the rid ring by a stable content hash
       (crc32 — NOT Python's salted ``hash``; placement must be
       reproducible across runs), so a group's stream concentrates and
       builds residency instead of spraying one cold miss onto every
       replica. SageServe's observation, applied at the router:
       cache state must be *built* by placement, not just consulted.
    3. **Spill on overload.** Either preference yields to the
       least-loaded replica when its outstanding mass (Eq. 1 tokens)
       exceeds ``spill_factor`` x the routable mean — work conservation
       beats warmth, exactly like ``tenant_affinity``'s spill.

    Requests with no shareable prefix route least-loaded. Residency
    probes are pure reads (no LRU/refcount perturbation), so scoring N
    replicas per placement cannot distort eviction order.
    """

    name = "prefix_aware"

    def __init__(self, spill_factor: float = 1.5) -> None:
        self.spill_factor = float(spill_factor)

    def select(self, replicas, req, est_budget, now):
        """Max resident-prefix overlap -> stable group-ring seed ->
        least-loaded spill (see class docstring)."""
        mean_mass = sum(r.token_mass() for r in replicas) / len(replicas)

        def overloaded(r: Replica) -> bool:
            return r.token_mass() > self.spill_factor * max(mean_mass, 1.0)

        if req.prefix_group is not None and req.shared_prefix_tokens > 0:
            overlaps = {r.rid: r.prefix_cached_tokens(req)
                        for r in replicas}
            best = max(replicas, key=lambda r: (overlaps[r.rid], -r.rid))
            if overlaps[best.rid] > 0 and not overloaded(best):
                return best
            target = zlib.crc32(repr(req.prefix_group).encode()) \
                % (replicas[-1].rid + 1)
            warm = next((r for r in replicas if r.rid >= target),
                        replicas[0])
            if not overloaded(warm):
                return warm
        return min(replicas, key=lambda r: (r.token_mass(), r.rid))


class PDDisaggregatedRouting(RoutingPolicy):
    """Prefill/decode-disaggregated two-stage placement.

    Admitted requests are placed on *prefill-capable* replicas by
    outstanding prompt-token load (prefill replicas only pay prompt
    processing, so their load is prompt mass — raw prompt tokens, not
    Eq. 1 budgets). Once prefill finishes, :meth:`select_decode` places
    the request on a *decode-capable* replica by outstanding estimated-
    token mass (Eq. 1 budgets — decode cost is output-length driven,
    which is exactly what the calibrated estimator predicts). The
    cluster simulator moves the KV between the two via a modeled
    transfer delay.

    Separating the pools removes prefill/decode contention: a long
    prompt no longer stalls the decode batch behind it
    (arXiv 2602.02987's head-of-line effect).
    """

    name = "pd_disaggregated"

    @staticmethod
    def _prompt_load(r: Replica) -> float:
        """Outstanding prompt tokens (queued + in flight) — the work a
        prefill replica actually pays for."""
        return (sum(q.prompt_tokens for q in r.queued_requests())
                + sum(q.prompt_tokens for q in r.inflight_requests()))

    def select(self, replicas, req, est_budget, now):
        """Stage 1: least prompt-loaded prefill-capable replica."""
        pool = [r for r in replicas if r.role.can_prefill()]
        if not pool:           # degenerate pool (e.g. every prefill
            pool = replicas    # replica failed): decode pool serves both
        return min(pool, key=lambda r: (self._prompt_load(r), r.rid))

    def select_decode(self, replicas: Sequence[Replica], req: Request,
                      est_budget: float, now: float) -> Optional[Replica]:
        """Stage 2: least-loaded decode-capable replica (estimated
        budget-token mass, Eq. 1), or None when no decode-capable
        replica is routable (caller parks the KV and retries)."""
        pool = [r for r in replicas if r.role.can_decode()]
        if not pool:
            return None
        return min(pool, key=lambda r: (r.token_mass(), r.rid))


ROUTING_POLICIES: Dict[str, type] = {
    p.name: p for p in (RoundRobinRouting, LeastLoadedRouting,
                        DriftAwareRouting, TenantAffinityRouting,
                        PrefixAwareRouting, PDDisaggregatedRouting)
}


def make_routing_policy(name: str, **kwargs) -> RoutingPolicy:
    """Instantiate a routing policy by registry name (case-insensitive);
    raises ValueError listing the registry on an unknown name."""
    try:
        cls = ROUTING_POLICIES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown routing policy {name!r}; "
                         f"available: {sorted(ROUTING_POLICIES)}") from None
    return cls(**kwargs)


@dataclass
class RoutingRecord:
    """One routing decision (cluster metrics / debugging).

    ``stage`` is "admit" for first placement (prefill placement under
    P/D disaggregation) and "decode" for the post-prefill handoff
    placement; ``est_budget`` is in estimated budget tokens (Eq. 1)."""

    time: float
    req_id: int
    tenant: str
    est_budget: float
    rid: int
    stage: str = "admit"


@dataclass(frozen=True)
class StealPlan:
    """One planned work-stealing move: ``n`` queued requests leave
    replica ``victim_rid`` for the idle replica ``thief_rid``. The owner
    (cluster simulator) executes the move; for decode-ready work it also
    pays a fresh KV-transfer delay, since the pages live on the
    victim.

    ``req_ids`` pins exactly which queued requests move: the planner
    filters the victim's queue tail for prefix-cache residency (work
    that is cheap *because* it is queued where its prefix is resident
    must not be dragged to a cold thief), so a bare count no longer
    identifies the moved set."""

    victim_rid: int
    thief_rid: int
    n: int
    req_ids: Tuple[int, ...] = ()


class ClusterRouter:
    """Routes admitted requests onto replicas.

    Uses the *shared* :class:`AdaptiveTokenEstimator` to price a request
    before it reaches any replica, so every routing decision sees the
    same calibrated bias state the replicas' admission controllers use.
    """

    def __init__(self, policy: str | RoutingPolicy,
                 estimator: AdaptiveTokenEstimator,
                 record_log: bool = True, trace=None) -> None:
        self.policy: RoutingPolicy = (
            policy if isinstance(policy, RoutingPolicy)
            else make_routing_policy(policy))
        self.estimator = estimator
        self.log: List[RoutingRecord] = []
        self._record = record_log
        self.trace = resolve_recorder(trace)

    def price(self, req: Request) -> float:
        """Estimated token budget (Eq. 1) under the current bias state.
        Uses the preserved admission estimate when one exists (reroutes
        must not be re-priced — the original estimate travels with the
        request, mirroring the single-replica readmit contract)."""
        if req.estimate is not None:
            return req.estimate.t_budget
        prompt_tokens = req.prompt_tokens or count_tokens(req.prompt)
        return self.estimator.estimate(
            req.category, req.tenant, prompt_tokens).t_budget

    def route(self, replicas: Sequence[Replica], req: Request, now: float,
              est_budget: Optional[float] = None,
              exclude: Sequence[Replica] = ()) -> Optional[Replica]:
        """Pick a routable replica, or None when the pool is empty
        (caller sheds or parks the request). ``est_budget`` lets a
        caller that already priced the request (the admission gate)
        skip re-estimating."""
        pool = [r for r in replicas if r.routable() and r not in exclude]
        if not pool:
            return None
        pool.sort(key=lambda r: r.rid)
        est = est_budget if est_budget is not None else self.price(req)
        chosen = self.policy.select(pool, req, est, now)
        chosen.n_routed += 1
        if self._record:
            self.log.append(RoutingRecord(
                time=now, req_id=req.req_id, tenant=req.tenant.label,
                est_budget=est, rid=chosen.rid))
        if self.trace.enabled:
            self.trace.emit(now, tr.ROUTE, req_id=req.req_id,
                            rid=chosen.rid, tenant=req.tenant.label,
                            stage="admit", policy=self.policy.name,
                            est_budget=est)
        return chosen

    def route_decode(self, replicas: Sequence[Replica], req: Request,
                     now: float,
                     exclude: Sequence[Replica] = ()) -> Optional[Replica]:
        """Stage-2 placement: pick the decode replica a prefilled
        request hands off to, or None when no decode-capable replica is
        routable (the caller parks the KV at its source and retries).
        Policies without a two-stage story (everything but
        ``pd_disaggregated``) fall back to :meth:`route`."""
        pool = [r for r in replicas if r.routable() and r not in exclude]
        if not pool:
            return None
        pool.sort(key=lambda r: r.rid)
        select_decode = getattr(self.policy, "select_decode", None)
        if select_decode is None:
            return self.route(replicas, req, now, exclude=exclude)
        est = self.price(req)
        chosen = select_decode(pool, req, est, now)
        if chosen is None:
            return None
        if self._record:
            self.log.append(RoutingRecord(
                time=now, req_id=req.req_id, tenant=req.tenant.label,
                est_budget=est, rid=chosen.rid, stage="decode"))
        if self.trace.enabled:
            self.trace.emit(now, tr.ROUTE, req_id=req.req_id,
                            rid=chosen.rid, tenant=req.tenant.label,
                            stage="decode", policy=self.policy.name,
                            est_budget=est)
        return chosen

    # --- work stealing -------------------------------------------------
    def plan_steals(self, replicas: Sequence[Replica], now: float, *,
                    min_victim_depth: int = 4) -> List[StealPlan]:
        """Cross-replica work stealing: pair every idle routable replica
        (thief) with its most-backlogged role-compatible peer (victim)
        and plan to move half the victim's queue (requests, counted —
        mass-greedy victims are picked by queued estimated-token mass).

        Role compatibility keys off the *phase the victim's queued work
        needs next*: a decode replica's queue holds prefilled,
        decode-ready requests, so only decode-capable thieves may take
        them; prefill and unified queues hold not-yet-prefilled work,
        so the thief must be prefill-capable. Replicas still DRAINING
        count as victims (stealing is precisely how their backlog drains
        faster) but never as thieves. Estimates travel with the stolen
        requests — stealing must not re-price work.

        **Prefix-cache residency veto.** Not-yet-prefilled work in the
        steal set consults measured residency
        (:meth:`Replica.prefix_cached_tokens`): moving a request whose
        shared prefix is resident on the victim but not on the thief
        forfeits that many cached prefill tokens, so the move is
        refused when the forfeited discount meets or exceeds the
        request's own estimated budget — the queue-imbalance gain one
        stolen request can relieve. Decode-ready work is exempt (its
        KV re-transfers either way), as is everything when no replica
        runs a prefix cache (zero residency everywhere: the plans are
        exactly the pre-veto ones).
        """
        thieves = sorted((r for r in replicas
                          if r.routable() and r.is_idle()),
                         key=lambda r: r.rid)
        taken: set = set()
        plans: List[StealPlan] = []
        for thief in thieves:
            candidates = [
                v for v in replicas
                if v is not thief and v.rid not in taken
                and v.state in (ReplicaState.ACTIVE, ReplicaState.DRAINING)
                and v.queue_depth() >= min_victim_depth
                and self._steal_compatible(v, thief)
            ]
            if not candidates:
                continue
            victim = max(candidates,
                         key=lambda v: (v.queued_token_mass(), -v.rid))
            n = victim.queue_depth() // 2
            if n <= 0:
                continue
            # the executor moves the queue *tail* (coldest end); veto
            # tail members whose residency discount outweighs the gain
            queued = victim.queued_requests()
            movable = [
                r for r in queued[len(queued) - n:]
                if r.prefill_end is not None
                or (victim.prefix_cached_tokens(r)
                    - thief.prefix_cached_tokens(r)) < _budget(r)
            ]
            if not movable:
                continue
            taken.add(victim.rid)
            plans.append(StealPlan(
                victim_rid=victim.rid, thief_rid=thief.rid,
                n=len(movable),
                req_ids=tuple(r.req_id for r in movable)))
        return plans

    @staticmethod
    def _steal_compatible(victim: Replica, thief: Replica) -> bool:
        if victim.role is ReplicaRole.DECODE:
            return thief.role.can_decode()
        # prefill / unified queues hold not-yet-prefilled work
        return thief.role.can_prefill()
