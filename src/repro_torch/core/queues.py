"""Tenant-aware queue management (Sec. II-E).

The paper backs its queues with Redis data structures (lists for FIFO
order, sorted sets for scored policies). This module reimplements those
semantics as deterministic in-memory structures so experiments are
reproducible bit-for-bit:

* :class:`FifoQueue`      — Redis list  (RPUSH / LPOP)
* :class:`ScoredQueue`    — Redis zset  (ZADD / ZPOPMIN), min-heap backed
* :class:`TenantQueueManager` — the three tenant service queues
  (Premium / Standard / Batch), each holding heterogeneous short /
  medium / long workloads.

Queue assignment depends on the workload classification produced by the
adaptive token-estimation layer, so improvements in drift compensation
directly influence queue composition (Sec. II-E, last paragraph).
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional

from .request import Request, RequestState, TenantTier


class FifoQueue:
    """Redis-list semantics: strict arrival order."""

    def __init__(self) -> None:
        self._q: deque[Request] = deque()

    def push(self, req: Request) -> None:
        self._q.append(req)

    def push_front(self, req: Request) -> None:
        """Re-queue at the head (used for failure retries so a retried
        request does not lose its place)."""
        self._q.appendleft(req)

    def pop(self) -> Optional[Request]:
        return self._q.popleft() if self._q else None

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)


class ScoredQueue:
    """Redis sorted-set semantics (ZADD / ZPOPMIN) on a binary heap.

    Scores may be recomputed lazily (aging): :meth:`pop_min_rescored`
    accepts a scoring function evaluated against *current* time, which
    re-scores the whole heap. For the queue sizes in the paper's
    experiments (<= a few thousand entries) this is cheap and keeps the
    semantics exact rather than approximating aging with stale scores.
    """

    _tie = itertools.count()

    def __init__(self) -> None:
        self._heap: List[tuple] = []

    def push(self, score: float, req: Request) -> None:
        heapq.heappush(self._heap, (score, next(self._tie), req))

    def pop_min(self) -> Optional[Request]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def peek_score(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def pop_min_rescored(self, score_fn: Callable[[Request], float]) -> Optional[Request]:
        if not self._heap:
            return None
        best_i, best_key = 0, None
        for i, (_, tie, req) in enumerate(self._heap):
            key = (score_fn(req), tie)
            if best_key is None or key < best_key:
                best_key, best_i = key, i
        # remove index best_i from the heap
        last = self._heap.pop()
        if best_i < len(self._heap):
            removed = self._heap[best_i]
            self._heap[best_i] = last
            heapq.heapify(self._heap)
            return removed[2]
        return last[2]

    def __len__(self) -> int:
        return len(self._heap)

    def __iter__(self):
        return (entry[2] for entry in self._heap)


class TenantQueueManager:
    """Three independent tenant queues (Sec. II-E).

    Internally each tenant queue preserves FIFO arrival order; scheduling
    policies impose their own selection order on top (Sec. II-F). The
    manager also tracks queue-depth history for Fig. 6 reproduction.
    """

    def __init__(self) -> None:
        self.queues: Dict[TenantTier, FifoQueue] = {
            t: FifoQueue() for t in TenantTier
        }
        # (time, depth_premium, depth_standard, depth_batch) samples
        self.depth_history: List[tuple] = []

    # ------------------------------------------------------------------
    def enqueue(self, req: Request, now: float, *, front: bool = False) -> None:
        req.enqueue_time = now
        req.state = RequestState.QUEUED
        if front:
            self.queues[req.tenant].push_front(req)
        else:
            self.queues[req.tenant].push(req)

    def depth(self, tenant: Optional[TenantTier] = None) -> int:
        if tenant is not None:
            return len(self.queues[tenant])
        return sum(len(q) for q in self.queues.values())

    def depths(self) -> Dict[TenantTier, int]:
        return {t: len(q) for t, q in self.queues.items()}

    def record_depth(self, now: float) -> None:
        d = self.depths()
        self.depth_history.append(
            (now, d[TenantTier.PREMIUM], d[TenantTier.STANDARD], d[TenantTier.BATCH])
        )

    def all_requests(self) -> Iterable[Request]:
        for q in self.queues.values():
            yield from q

    def is_empty(self) -> bool:
        return self.depth() == 0

    # --- checkpoint/restore (fault tolerance) -------------------------
    def drain(self) -> List[Request]:
        """Remove and return every queued request (used when re-meshing
        or restoring from checkpoint)."""
        out: List[Request] = []
        for q in self.queues.values():
            while True:
                r = q.pop()
                if r is None:
                    break
                out.append(r)
        return out
