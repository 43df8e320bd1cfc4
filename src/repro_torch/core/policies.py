"""Scheduling policies (Sec. II-F).

Five policies, all selecting from the :class:`TenantQueueManager`:

* :class:`FifoPolicy`          — strict global arrival order (Sec. II-F1)
* :class:`PriorityPolicy`      — tenant-tier precedence, FIFO within tier,
  score = priority_score * 1e12 + arrival_time (Sec. II-F2)
* :class:`SjfPolicy`           — smallest estimated token budget first
  (Sec. II-F3); directly consumes the adaptive estimator's budgets.
* :class:`WeightedPolicy`      — cyclic dispatch over a Premium:Standard:
  Batch ratio (Sec. II-F4; ratio redacted in the paper, default 5:3:2,
  see DESIGN.md §2)
* :class:`AgingPriorityPolicy` — priority score decays with queue waiting
  time so long-waiting requests eventually execute (Sec. II-F5)

Every policy implements ``select(manager, now) -> Optional[Request]``,
removing and returning the chosen request. Selection is deterministic:
ties break on the monotone admission sequence number.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .queues import TenantQueueManager
from .request import Request, TenantTier

PRIORITY_SCALE = 1e12  # paper: score = priority_score * 10^12 + arrival_time


class SchedulingPolicy:
    """Base class. Subclasses override :meth:`select`."""

    name: str = "base"

    def select(self, manager: TenantQueueManager, now: float) -> Optional[Request]:
        raise NotImplementedError

    # Policies are stateless unless noted; Weighted keeps a cycle cursor.
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass

    # ------------------------------------------------------------------
    @staticmethod
    def _pop_head_min(
        manager: TenantQueueManager,
        key_fn,
    ) -> Optional[Request]:
        """Pop the queue-head request minimising ``key_fn`` across the
        three tenant queues (used when FIFO-within-tier is preserved)."""
        best_tier, best_key = None, None
        for tier, q in manager.queues.items():
            head = q.peek()
            if head is None:
                continue
            key = key_fn(head)
            if best_key is None or key < best_key:
                best_key, best_tier = key, tier
        if best_tier is None:
            return None
        return manager.queues[best_tier].pop()

    @staticmethod
    def _pop_scan_min(
        manager: TenantQueueManager,
        key_fn,
    ) -> Optional[Request]:
        """Pop the request minimising ``key_fn`` over *all* queued
        requests (needed when in-tier order is not score order, e.g. SJF
        and Aging). O(depth) per dispatch — exact Redis-zset semantics."""
        best_req, best_key = None, None
        for req in manager.all_requests():
            key = key_fn(req)
            if best_key is None or key < best_key:
                best_key, best_req = key, req
        if best_req is None:
            return None
        manager.queues[best_req.tenant]._q.remove(best_req)  # O(n) removal
        return best_req


class FifoPolicy(SchedulingPolicy):
    """Strict arrival order, tenant-blind (Sec. II-F1)."""

    name = "fifo"

    def select(self, manager: TenantQueueManager, now: float) -> Optional[Request]:
        # Global FIFO == min admission sequence across per-tenant heads
        # (each tenant queue is itself in arrival order).
        return self._pop_head_min(manager, lambda r: (r.seq,))


class PriorityPolicy(SchedulingPolicy):
    """Premium > Standard > Batch; FIFO within tier (Sec. II-F2)."""

    name = "priority"

    def select(self, manager: TenantQueueManager, now: float) -> Optional[Request]:
        return self._pop_head_min(
            manager,
            lambda r: (int(r.tenant) * PRIORITY_SCALE + r.arrival_time, r.seq),
        )


class SjfPolicy(SchedulingPolicy):
    """Shortest (estimated) job first (Sec. II-F3).

    Sensitive by construction to the adaptive token estimator: the key is
    the admission-time ``t_budget`` (Eq. 1), so drift compensation
    directly changes dispatch order.
    """

    name = "sjf"

    def select(self, manager: TenantQueueManager, now: float) -> Optional[Request]:
        return self._pop_scan_min(manager, lambda r: (r.t_budget, r.seq))


class WeightedPolicy(SchedulingPolicy):
    """Cyclic weighted dispatch across tenant classes (Sec. II-F4).

    The paper redacts the Premium:Standard:Batch ratio; we default to
    5:3:2 (DESIGN.md §2). The cursor advances through an expanded cycle
    pattern; empty classes are skipped so capacity is never idled.
    """

    name = "weighted"

    def __init__(self, ratio: Sequence[int] = (5, 3, 2)) -> None:
        if len(ratio) != len(TenantTier):
            raise ValueError("ratio must have one entry per tenant tier")
        self.ratio = tuple(int(x) for x in ratio)
        self._pattern: List[TenantTier] = []
        for tier, weight in zip(TenantTier, self.ratio):
            self._pattern.extend([tier] * weight)
        self._cursor = 0

    def select(self, manager: TenantQueueManager, now: float) -> Optional[Request]:
        if manager.is_empty():
            return None
        n = len(self._pattern)
        for step in range(n):
            tier = self._pattern[(self._cursor + step) % n]
            req = manager.queues[tier].pop()
            if req is not None:
                self._cursor = (self._cursor + step + 1) % n
                return req
        return None  # unreachable: manager not empty

    def state_dict(self) -> dict:
        return {"cursor": self._cursor, "ratio": list(self.ratio)}

    def load_state_dict(self, state: dict) -> None:
        self._cursor = int(state.get("cursor", 0))


class AgingPriorityPolicy(SchedulingPolicy):
    """Priority with starvation mitigation (Sec. II-F5).

    Effective score = tier * aging_threshold - waiting_time. Waiting time
    progressively reduces the score, so a Batch request that has waited
    longer than ``2 * aging_threshold`` seconds outranks a fresh Premium
    request. The default threshold keeps behaviour close to strict
    Priority (paper Tables III/V: Aging ~= Priority for tenant QoS, with
    slightly higher tail latency from periodic promotions).
    """

    name = "aging"

    def __init__(self, aging_threshold: float = 240.0, aging_rate: float = 1.0) -> None:
        self.aging_threshold = float(aging_threshold)
        self.aging_rate = float(aging_rate)

    def select(self, manager: TenantQueueManager, now: float) -> Optional[Request]:
        def score(r: Request):
            wait = now - r.enqueue_time
            return (int(r.tenant) * self.aging_threshold - self.aging_rate * wait,
                    r.seq)

        return self._pop_scan_min(manager, score)


POLICIES: Dict[str, type] = {
    p.name: p
    for p in (FifoPolicy, PriorityPolicy, SjfPolicy, WeightedPolicy, AgingPriorityPolicy)
}


def make_policy(name: str, **kwargs) -> SchedulingPolicy:
    try:
        cls = POLICIES[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; available: {sorted(POLICIES)}"
        ) from None
    return cls(**kwargs)
