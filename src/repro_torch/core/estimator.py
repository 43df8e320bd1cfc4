"""Adaptive token-budget estimation with runtime drift compensation.

Implements the paper's Eq. 1-2 (admission-time estimate) and Eq. 5-6
(EMA bias update):

    T_budget           = T_input + T_estimated_output                (1)
    T_estimated_output = T_base * B_runtime * S_tenant * F_input     (2)
    B_new              = (1 - alpha) * B_old + alpha * B_measured    (5)
    B_measured         = T_actual / T_base                           (6)

``B_runtime`` is tracked *per semantic workload category* (Sec. II-J,
Fig. 5: one bias curve per category, all initialised at 1.0). The
estimator is a pure host-side component — it runs at admission time on
the CPU, off the accelerator critical path, exactly as in the paper.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

from .request import Category, Estimate, JobClass, TenantTier


@dataclass(frozen=True)
class DriftConfig:
    """All estimator constants. Paper-unspecified values are documented
    in DESIGN.md §2 and chosen to reproduce the published bias band."""

    # T_base — baseline workload token estimate per semantic category.
    base_estimates: Mapping[Category, float] = field(
        default_factory=lambda: {
            Category.SHORT_QA: 64.0,
            Category.SUMMARY: 288.0,
            Category.TECHNICAL: 416.0,
            Category.REPORT: 600.0,
        }
    )
    # S_tenant — tenant-aware safety scaling (premium over-provisions).
    tenant_safety: Mapping[TenantTier, float] = field(
        default_factory=lambda: {
            TenantTier.PREMIUM: 1.15,
            TenantTier.STANDARD: 1.05,
            TenantTier.BATCH: 1.0,
        }
    )
    # EMA learning rate (Eq. 5).
    ema_alpha: float = 0.10
    # BIAS=ON / BIAS=OFF switch (Sec. III-B).
    bias_enabled: bool = True
    bias_init: float = 1.0
    # Clamp on B_measured so a single pathological request cannot wreck
    # the estimate (robustness; not in the paper but harmless).
    bias_clip: Tuple[float, float] = (0.1, 4.0)
    # F_input — prompt-complexity scaling: log-scaled around a reference
    # prompt length, clipped. Longer prompts historically elicit longer
    # answers (Sec. II-C1). The reference sits below typical prompt
    # lengths so static estimation systematically over-provisions —
    # the paper's observed direction of runtime token drift.
    f_input_ref_tokens: float = 6.0
    f_input_log_slope: float = 0.10
    f_input_clip: Tuple[float, float] = (0.90, 1.40)
    # Runtime classification thresholds (Eq. 3).
    short_threshold: float = 128.0
    long_threshold: float = 512.0


@dataclass
class BiasSnapshot:
    """One point of the per-category bias trajectory (for Fig. 5)."""

    step: int
    time: float
    category: str
    bias: float


class BiasStore:
    """Per-category adaptive bias factors with EMA updates.

    Thread-safe: the real serving engine completes requests from worker
    threads while admission happens on the gateway thread.
    """

    def __init__(self, config: DriftConfig):
        self.config = config
        self._bias: Dict[Category, float] = {
            c: config.bias_init for c in Category
        }
        self._updates: Dict[Category, int] = {c: 0 for c in Category}
        self._lock = threading.Lock()
        self.history: List[BiasSnapshot] = []
        self._step = 0

    def get(self, category: Category) -> float:
        if not self.config.bias_enabled:
            return self.config.bias_init
        with self._lock:
            return self._bias[category]

    def update(self, category: Category, t_actual: float, now: float = 0.0) -> float:
        """Eq. 5-6. Returns the new bias. No-op under BIAS=OFF (the paper
        still *measures* drift under BIAS=OFF, it just never corrects)."""
        cfg = self.config
        t_base = cfg.base_estimates[category]
        lo, hi = cfg.bias_clip
        b_measured = min(max(t_actual / t_base, lo), hi)
        with self._lock:
            if cfg.bias_enabled:
                b_old = self._bias[category]
                b_new = (1.0 - cfg.ema_alpha) * b_old + cfg.ema_alpha * b_measured
                self._bias[category] = b_new
            else:
                b_new = self._bias[category]
            self._updates[category] += 1
            self._step += 1
            self.history.append(
                BiasSnapshot(self._step, now, category.value, b_new)
            )
            return b_new

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {c.value: b for c, b in self._bias.items()}

    def update_counts(self) -> Dict[str, int]:
        with self._lock:
            return {c.value: n for c, n in self._updates.items()}

    # --- checkpoint/restore (fault tolerance) -------------------------
    def state_dict(self) -> dict:
        with self._lock:
            return {
                "bias": {c.value: b for c, b in self._bias.items()},
                "updates": {c.value: n for c, n in self._updates.items()},
                "step": self._step,
            }

    def load_state_dict(self, state: dict) -> None:
        with self._lock:
            for c in Category:
                if c.value in state.get("bias", {}):
                    self._bias[c] = float(state["bias"][c.value])
                if c.value in state.get("updates", {}):
                    self._updates[c] = int(state["updates"][c.value])
            self._step = int(state.get("step", self._step))


class AdaptiveTokenEstimator:
    """The workload-analysis layer estimator (Sec. II-C1, Algorithm 2)."""

    def __init__(self, config: Optional[DriftConfig] = None,
                 bias_store: Optional[BiasStore] = None):
        self.config = config or DriftConfig()
        self.bias_store = bias_store or BiasStore(self.config)

    # -- Eq. 2 factor helpers ------------------------------------------
    def f_input(self, prompt_tokens: int) -> float:
        cfg = self.config
        ratio = max(float(prompt_tokens), 1.0) / cfg.f_input_ref_tokens
        raw = 1.0 + cfg.f_input_log_slope * math.log2(ratio)
        lo, hi = cfg.f_input_clip
        return min(max(raw, lo), hi)

    def classify_budget(self, t_budget: float) -> JobClass:
        """Eq. 3-4: runtime scheduling class from the estimated budget."""
        cfg = self.config
        if t_budget <= cfg.short_threshold:
            return JobClass.SHORT
        if t_budget <= cfg.long_threshold:
            return JobClass.MEDIUM
        return JobClass.LONG

    # -- Algorithm 2 ----------------------------------------------------
    def estimate(self, category: Category, tenant: TenantTier,
                 prompt_tokens: int, cached_tokens: int = 0) -> Estimate:
        """Admission-time estimate (Eq. 1-2). ``cached_tokens`` is the
        prompt prefix expected to be resident in the target replica's
        KV cache (set by prefix-aware placement): those tokens cost no
        prefill work, so the budget prices only the uncached suffix.
        ``F_input`` still reads the FULL prompt — output length depends
        on what the model sees, not on what was re-computed — so cache
        hits change the work estimate, never the output estimate."""
        cfg = self.config
        t_base = cfg.base_estimates[category]
        bias = self.bias_store.get(category)
        safety = cfg.tenant_safety[tenant]
        f_in = self.f_input(prompt_tokens)
        est_out = t_base * bias * safety * f_in              # Eq. 2
        cached = min(max(int(cached_tokens), 0), int(prompt_tokens))
        t_budget = float(prompt_tokens - cached) + est_out   # Eq. 1
        return Estimate(
            t_base=t_base,
            bias=bias,
            safety=safety,
            f_input=f_in,
            est_output_tokens=est_out,
            t_budget=t_budget,
            job_class=self.classify_budget(t_budget),
            cached_tokens=cached,
        )

    # -- Sec. II-J feedback ---------------------------------------------
    def feedback(self, category: Category, observed_output_tokens: float,
                 now: float = 0.0) -> float:
        return self.bias_store.update(category, observed_output_tokens, now)
