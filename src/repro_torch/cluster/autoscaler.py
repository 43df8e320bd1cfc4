"""Elastic autoscaling from utilization + queue-mass signals.

The autoscaler watches two cluster signals at every control tick:

* **queue mass per active replica** — outstanding estimated-token mass
  (Eq. 1 budgets) divided by the active replica count; the demand
  signal. Token mass, not request count: ten queued reports are a very
  different backlog than ten short QAs, and the calibrated estimator is
  what makes the distinction trustworthy.
* **worker utilization** — busy workers / alive workers; the supply
  signal for scale-down.

Decisions use hysteresis (disjoint up/down thresholds) plus a cooldown
after *any* action, so a burst cannot flap the pool. The autoscaler
only *decides*; the owner (cluster simulator or driver) provisions the
replica (with a cold-start delay) or marks one draining.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import events as _tr
from ..obs import resolve_recorder
from .replica import Replica, ReplicaRole, ReplicaState

SCALE_UP = "up"
SCALE_DOWN = "down"


@dataclass(frozen=True)
class AutoscalerConfig:
    """Scaling limits and hysteresis thresholds. Queue-mass thresholds
    are in estimated budget tokens (Eq. 1) per active replica;
    utilization in [0, 1]; times in seconds."""

    min_replicas: int = 1
    max_replicas: int = 8
    # scale up when queue mass per active replica exceeds this
    up_queue_mass_per_replica: float = 20_000.0
    # scale down only when BOTH hold (hysteresis band)
    down_queue_mass_per_replica: float = 2_000.0
    down_utilization: float = 0.5
    cooldown: float = 20.0           # s between scaling actions
    startup_delay: float = 5.0       # cold start before a replica serves


@dataclass
class ScaleEvent:
    """One autoscaling decision: when, which way, and the signal values
    (queue mass in estimated budget tokens per active replica,
    utilization in [0, 1]) that justified it. ``role`` is set by the
    role-aware autoscaler to the pool ("prefill" / "decode") the action
    targets; None for whole-pool (unified) decisions."""

    time: float
    action: str                      # "up" | "down"
    n_active: int                    # active count when decided
    queue_mass_per_replica: float
    utilization: float
    role: Optional[str] = None


class Autoscaler:
    """Hysteresis + cooldown scaling decisions over the replica pool."""

    def __init__(self, config: Optional[AutoscalerConfig] = None,
                 trace=None) -> None:
        self.cfg = config or AutoscalerConfig()
        self.events: List[ScaleEvent] = []
        self._last_action_time = -float("inf")
        self.trace = resolve_recorder(trace)

    # ------------------------------------------------------------------
    @staticmethod
    def signals(replicas: Sequence[Replica]) -> tuple:
        """(queue_mass_per_active_replica, utilization, n_active)."""
        active = [r for r in replicas if r.state is ReplicaState.ACTIVE]
        if not active:
            return 0.0, 0.0, 0
        mass = sum(r.token_mass() for r in active) / len(active)
        busy = sum(r.busy_workers() for r in active)
        alive = sum(r.alive_workers() for r in active)
        util = busy / alive if alive else 0.0
        return mass, util, len(active)

    def decide(self, now: float, replicas: Sequence[Replica],
               n_starting: int = 0) -> Optional[str]:
        """Return SCALE_UP, SCALE_DOWN, or None. ``n_starting`` counts
        replicas already provisioning (they count toward max and damp
        repeated scale-ups during their cold start)."""
        cfg = self.cfg
        if now - self._last_action_time < cfg.cooldown:
            return None
        mass, util, n_active = self.signals(replicas)
        if n_active == 0:
            return None
        pool = n_active + n_starting
        action: Optional[str] = None
        if mass > cfg.up_queue_mass_per_replica and pool < cfg.max_replicas:
            action = SCALE_UP
        elif (mass < cfg.down_queue_mass_per_replica
              and util < cfg.down_utilization
              and n_active > cfg.min_replicas and n_starting == 0):
            action = SCALE_DOWN
        if action is not None:
            self._last_action_time = now
            self.events.append(ScaleEvent(
                time=now, action=action, n_active=n_active,
                queue_mass_per_replica=mass, utilization=util))
            if self.trace.enabled:
                self.trace.emit(
                    now, _tr.SCALE_UP if action == SCALE_UP
                    else _tr.SCALE_DOWN,
                    n_active=n_active, queue_mass_per_replica=mass,
                    utilization=util)
        return action

    def pick_drain_target(self, replicas: Sequence[Replica]) -> Optional[Replica]:
        """Least-loaded active replica drains first (cheapest to empty)."""
        active = [r for r in replicas if r.state is ReplicaState.ACTIVE]
        if len(active) <= self.cfg.min_replicas:
            return None
        return min(active, key=lambda r: (r.token_mass(), -r.rid))


@dataclass(frozen=True)
class RoleAutoscalerConfig(AutoscalerConfig):
    """Role-aware scaling limits. Inherits the hysteresis thresholds
    (applied *per role pool*: queue mass in estimated budget tokens per
    active replica of that role) and adds the pool-shape target."""

    # target share of the pool that should be prefill replicas. None
    # (the default) inherits the owner's topology target — the cluster
    # simulator passes the fraction its pool was actually built with
    # (ClusterConfig.pd_prefill_fraction / n_prefill_replicas) — so the
    # autoscaler never fights a non-default initial split. An explicit
    # value here overrides that; standalone use falls back to 0.25
    # (decode work dominates token time under both L4 cost regimes).
    target_prefill_fraction: Optional[float] = None


class RoleAutoscaler(Autoscaler):
    """Per-role scaling for a P/D-disaggregated pool (SageServe-style
    role-aware scaling of a heterogeneous replica fleet).

    Each role pool (prefill / decode) is watched with the same
    hysteresis signals the unified autoscaler uses — queue mass per
    active replica of that role (estimated budget tokens, Eq. 1) and
    busy/alive worker utilization — and actions name the role they
    apply to. Scale-up goes to the most overloaded role; scale-down
    drains from the role most over-provisioned relative to
    ``target_prefill_fraction``, never below one replica per role.
    """

    ROLES = (ReplicaRole.PREFILL, ReplicaRole.DECODE)

    def __init__(self, config: Optional[RoleAutoscalerConfig] = None,
                 trace=None) -> None:
        super().__init__(config or RoleAutoscalerConfig(), trace=trace)

    @staticmethod
    def role_signals(replicas: Sequence[Replica],
                     role: ReplicaRole) -> tuple:
        """(queue_mass_per_active_replica, utilization, n_active) for
        one role pool; mass in estimated budget tokens (Eq. 1)."""
        return Autoscaler.signals(
            [r for r in replicas if r.role is role])

    def decide_role(self, now: float, replicas: Sequence[Replica],
                    n_starting_by_role: Optional[
                        Dict[ReplicaRole, int]] = None,
                    default_target: Optional[float] = None
                    ) -> Optional[Tuple[str, ReplicaRole]]:
        """Return (SCALE_UP | SCALE_DOWN, role) or None.

        ``n_starting_by_role`` counts replicas already provisioning per
        role; they count toward ``max_replicas`` (whole-pool cap) and
        toward the pool shape, damping repeated scale-ups during cold
        starts. ``default_target`` is the owner's prefill-share target,
        used when the config leaves ``target_prefill_fraction`` unset."""
        cfg: RoleAutoscalerConfig = self.cfg  # type: ignore[assignment]
        if now - self._last_action_time < cfg.cooldown:
            return None
        starting = n_starting_by_role or {}
        sig = {role: self.role_signals(replicas, role)
               for role in self.ROLES}
        n_active_total = sum(s[2] for s in sig.values())
        if n_active_total == 0:
            return None
        pool_total = n_active_total + sum(starting.values())

        # scale up: the role with the larger per-replica backlog wins
        overloaded = [(sig[role][0], role.value, role) for role in self.ROLES
                      if sig[role][0] > cfg.up_queue_mass_per_replica]
        if overloaded and pool_total < cfg.max_replicas:
            _, _, role = max(overloaded)
            return self._emit(now, SCALE_UP, role, sig[role])

        # scale down: every pool must be inside the hysteresis band
        calm = all(s[0] < cfg.down_queue_mass_per_replica
                   and s[1] < cfg.down_utilization
                   for s in sig.values() if s[2] > 0)
        if (calm and n_active_total > max(cfg.min_replicas, 2)
                and not any(starting.values())):
            role = self._overprovisioned_role(sig, starting, cfg,
                                              default_target)
            if role is not None:
                return self._emit(now, SCALE_DOWN, role, sig[role])
        return None

    def _overprovisioned_role(self, sig, starting, cfg, default_target):
        """The role whose pool share most exceeds its target share;
        None when neither pool can give up a replica (≥1 each kept)."""
        target = cfg.target_prefill_fraction
        if target is None:
            target = default_target if default_target is not None else 0.25
        n_prefill = sig[ReplicaRole.PREFILL][2] \
            + starting.get(ReplicaRole.PREFILL, 0)
        n_decode = sig[ReplicaRole.DECODE][2] \
            + starting.get(ReplicaRole.DECODE, 0)
        total = n_prefill + n_decode
        if total == 0:
            return None
        excess_prefill = n_prefill / total - target
        candidates = []
        if n_prefill > 1:
            candidates.append((excess_prefill, ReplicaRole.PREFILL))
        if n_decode > 1:
            candidates.append((-excess_prefill, ReplicaRole.DECODE))
        if not candidates:
            return None
        return max(candidates, key=lambda c: c[0])[1]

    def _emit(self, now: float, action: str, role: ReplicaRole,
              sig: tuple) -> Tuple[str, ReplicaRole]:
        self._last_action_time = now
        self.events.append(ScaleEvent(
            time=now, action=action, n_active=sig[2],
            queue_mass_per_replica=sig[0], utilization=sig[1],
            role=role.value))
        if self.trace.enabled:
            self.trace.emit(
                now, _tr.SCALE_UP if action == SCALE_UP
                else _tr.SCALE_DOWN,
                role=role.value, n_active=sig[2],
                queue_mass_per_replica=sig[0], utilization=sig[1])
        return action, role

    def pick_drain_target(self, replicas: Sequence[Replica],
                          role: Optional[ReplicaRole] = None
                          ) -> Optional[Replica]:
        """Least-loaded active replica of ``role`` (whole pool when
        None), keeping at least one active replica per role."""
        if role is None:
            return super().pick_drain_target(replicas)
        active = [r for r in replicas
                  if r.state is ReplicaState.ACTIVE and r.role is role]
        if len(active) <= 1:
            return None
        return min(active, key=lambda r: (r.token_mass(), -r.rid))
