"""Fault-tolerance machinery for 1000+-node operation (DESIGN.md §7).

Host-side, execution-agnostic components — the discrete-event simulator
injects failures through them and the real engine wires them to wall
clocks:

* :class:`HeartbeatMonitor`   — dead-worker detection by heartbeat age;
* :class:`StragglerDetector`  — per-worker EWMA slowdown detection plus
  the hedged-dispatch decision rule (re-issue a request elsewhere when
  its wait exceeds the tail of the expected distribution);
* :func:`elastic_plan`        — given the surviving chip count, the
  largest runnable (data, model) re-mesh and the re-sharding actions
  (re-lower on the smaller data axis; ZeRO state re-sharded).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class HeartbeatMonitor:
    """Workers ping; anything silent for ``timeout`` seconds is dead."""

    def __init__(self, timeout: float = 15.0):
        self.timeout = timeout
        self._last: Dict[int, float] = {}
        self._dead: set = set()

    def beat(self, worker_id: int, now: float) -> None:
        self._last[worker_id] = now
        self._dead.discard(worker_id)

    def dead_workers(self, now: float) -> List[int]:
        newly = [w for w, t in self._last.items()
                 if w not in self._dead and now - t > self.timeout]
        self._dead.update(newly)
        return newly

    def alive(self, now: float) -> List[int]:
        return [w for w, t in self._last.items()
                if w not in self._dead and now - t <= self.timeout]


@dataclass
class WorkerStats:
    ewma: float = 0.0
    n: int = 0


class StragglerDetector:
    """EWMA per-worker step time; flags workers slower than
    ``threshold`` x the fleet median (straggler mitigation)."""

    def __init__(self, alpha: float = 0.2, threshold: float = 1.8):
        self.alpha = alpha
        self.threshold = threshold
        self.stats: Dict[int, WorkerStats] = {}

    def observe(self, worker_id: int, step_time: float) -> None:
        s = self.stats.setdefault(worker_id, WorkerStats())
        if s.n == 0:
            s.ewma = step_time
        else:
            s.ewma = (1 - self.alpha) * s.ewma + self.alpha * step_time
        s.n += 1

    @staticmethod
    def _median(vals: List[float]) -> float:
        vals = sorted(vals)
        if not vals:
            return 0.0
        mid = len(vals) // 2
        return (vals[mid] if len(vals) % 2 else
                0.5 * (vals[mid - 1] + vals[mid]))

    def fleet_median(self) -> float:
        return self._median([s.ewma for s in self.stats.values() if s.n > 0])

    def stragglers(self) -> List[int]:
        """Leave-one-out comparison: a worker is a straggler when it is
        ``threshold`` x slower than the median of the *other* workers
        (the pooled median would mask the straggler in small fleets)."""
        out = []
        for w, s in self.stats.items():
            if s.n < 3:
                continue
            others = [t.ewma for ww, t in self.stats.items()
                      if ww != w and t.n > 0]
            med = self._median(others)
            if med > 0 and s.ewma > self.threshold * med:
                out.append(w)
        return out

    # -- hedged dispatch -----------------------------------------------
    def should_hedge(self, wait_time: float, p99_expected: float) -> bool:
        """Re-issue a request to a second worker when its queue wait has
        exceeded the expected P99 (Dean & Barroso hedging rule)."""
        return p99_expected > 0 and wait_time > p99_expected


# ---------------------------------------------------------------------------
# elastic re-scale
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    dropped_chips: int
    actions: Tuple[str, ...]


def elastic_plan(n_chips: int, *, model_parallel: int = 16,
                 prefer_pods: bool = True) -> ElasticPlan:
    """Largest runnable mesh after failures.

    Keeps the model axis intact (TP degree is fixed by the weight
    sharding) and shrinks the data axis — the standard elastic-DP
    recovery. If fewer than one TP group survives, reduce TP to the
    largest power-of-two that fits.
    """
    actions = []
    tp = model_parallel
    if n_chips < tp:
        while tp > 1 and n_chips < tp:
            tp //= 2
        actions.append(f"reduce TP to {tp} (re-shard params)")
    dp = n_chips // tp
    if dp == 0:
        raise ValueError(f"cannot build a mesh from {n_chips} chips")
    used = dp * tp
    dropped = n_chips - used
    if dropped:
        actions.append(f"idle {dropped} chips (non-rectangular remainder)")
    actions.append(f"re-lower train/serve step on ({dp}, {tp}) mesh")
    actions.append("re-shard ZeRO optimizer state over the new data axis")
    actions.append("re-queue in-flight requests (at-most-once dispatch)")
    return ElasticPlan(
        mesh_shape=(dp, tp),
        mesh_axes=("data", "model"),
        dropped_chips=dropped,
        actions=tuple(actions),
    )
