"""Service-time model for the cluster simulator.

Two calibrations:

* ``L4_QWEN_1_8B`` — mirrors the paper's measurement platform (NVIDIA
  L4, Qwen1.5-1.8B FP16, vLLM, GPU batch 32). Constants are fitted so
  the FIFO baseline lands on the paper's own observations: per-batch
  GPU execution P50 ~= 10.5 s with a tight tail (P99 ~= 11.3 s, Fig 9),
  queue-dominated e2e latencies (Tables III-IV).
* ``from_roofline`` — TPU projection: reads a roofline JSON produced by
  the dry-run analysis and converts the per-step lower bound into
  per-token service rates, so the same simulator projects DriftSched
  behaviour onto the v5e serving deployment.

The primitive is one continuous-batching *iteration* (Orca/vLLM /
Sarathi chunked prefill):

    T(step) = c_decode_max                      # per-iteration walk/launch
            + c_decode_sum * n_decoding         # one token per active slot
            + c_prefill * prefill_tokens        # chunked-prefill share

:meth:`CostModel.batch_time` — the paper's atomic-batch price (worker
timestamps recorded around each GPU batch, Sec. II-I) — is the *derived
legacy view*: the closed form of ``t_base`` plus the sum of step times
over a batch run to completion with unbounded chunk budget and no
mid-flight joins,

    T(batch) = t_base + c_prefill * sum(prompt_tokens)
             + c_decode_max * max(output_tokens)       # batch walks to
             + c_decode_sum * sum(output_tokens)       # its longest member

(slot i emits in iterations 1..out_i, so the sum telescopes). The
identity is locked by ``tests/test_step_engine.py``; the L4
calibrations below were fitted against the atomic view and stay
meaningful for the step engine because of it.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, replace
from typing import Iterable, Optional

from ..core.request import Request


@dataclass(frozen=True)
class CostModel:
    name: str
    t_base: float            # fixed per-batch launch/teardown
    c_prefill: float         # s per prompt token (summed over batch)
    c_decode_max: float      # s per token of the batch's longest output
    c_decode_sum: float      # s per output token summed over batch
    jitter_sigma: float = 0.02   # lognormal execution noise

    def step_time(self, n_decoding: int, prefill_tokens: int = 0, *,
                  cached_tokens: int = 0, include_base: bool = False,
                  jitter: float = 1.0) -> float:
        """Price ONE continuous-batching iteration: ``n_decoding`` slots
        each emit one token, plus a chunked-prefill share of
        ``prefill_tokens`` prompt tokens processed alongside them
        (Sarathi-style piggybacking). ``cached_tokens`` of those prompt
        tokens are resident in the prefix KV cache and cost nothing —
        only the uncached suffix is priced (the step engine already
        passes net chunk sizes; the argument serves callers pricing a
        request's remaining prefill against known cache state). Decode
        cost is unaffected: attention still reads the cached pages.
        ``include_base`` adds the per-dispatch launch overhead
        ``t_base`` — charged once per batch formation, not per
        iteration (continuous batching amortises the launch across the
        busy period). Returns 0 for an empty step."""
        prefill_tokens = max(prefill_tokens - cached_tokens, 0)
        if n_decoding <= 0 and prefill_tokens <= 0:
            return 0.0
        t = (self.c_decode_max
             + self.c_decode_sum * n_decoding
             + self.c_prefill * prefill_tokens)
        if include_base:
            t += self.t_base
        return t * jitter

    def decode_step_time(self, n_decoding: int) -> float:
        """Pre-jitter price of one pure-decode iteration with
        ``n_decoding`` emitting slots. Delegates to :meth:`step_time`
        so the value is bit-identical to what the per-step engine pays
        (``x * 1.0 == x`` exactly in IEEE arithmetic) — the epoch-
        batched fast paths in ``repro.serving.vector_sim`` multiply
        this base by per-iteration jitter draws and MUST price each
        collapsed iteration to the same float the object engine
        would."""
        return self.step_time(n_decoding, 0, include_base=False,
                              jitter=1.0)

    def batch_time(self, requests: Iterable[Request], *,
                   cached_tokens: int = 0, jitter: float = 1.0) -> float:
        """Atomic-batch price — the derived/legacy view of
        :meth:`step_time` (see module docstring for the telescoped
        identity): the batch prefills every prompt up front and decodes
        until its longest member finishes. ``cached_tokens`` discounts
        prompt tokens resident in the prefix KV cache (summed over the
        batch) — the atomic executor itself never populates a prefix
        cache, so this serves estimation callers only."""
        reqs = list(requests)
        if not reqs:
            return 0.0
        sum_prompt = max(
            sum(r.prompt_tokens for r in reqs) - cached_tokens, 0)
        outs = [min(r.true_output_tokens, r.max_tokens) for r in reqs]
        t = (self.t_base
             + self.c_prefill * sum_prompt
             + self.c_decode_max * max(outs)
             + self.c_decode_sum * sum(outs))
        return t * jitter

    def jitter(self, rng) -> float:
        if self.jitter_sigma <= 0:
            return 1.0
        return math.exp(rng.gauss(0.0, self.jitter_sigma)
                        - 0.5 * self.jitter_sigma ** 2)


# Paper platform: Qwen1.5-1.8B FP16 on one NVIDIA L4 via vLLM.
# Calibrated by grid search against the paper's own FIFO/SJF
# observations (Tables III-IV): full FIFO batches execute in ~10-12 s
# with a tight tail (Fig 9), total GPU time is mostly token-volume
# driven (continuous batching) with a batch-walk component on the
# longest member, giving SJF its throughput edge. See EXPERIMENTS.md
# §Paper-validation for the residuals.
L4_QWEN_1_8B = CostModel(
    name="l4-qwen1.5-1.8b",
    t_base=0.25,
    c_prefill=5e-5,
    c_decode_max=3.7e-3,
    c_decode_sum=1.22e-3,
)


# Alternative calibration: batch time dominated by the longest member
# (each dispatched batch runs to completion before the next, so the
# near-cap report in every saturated FIFO batch walks it). Under this
# regime SJF's homogeneous batches genuinely shorten total GPU time —
# reproducing the paper's SJF P99 win (Table III) — but shorts then
# drain so fast that SJF's P50/wait land far below the paper's.
# bench_tail_latency reports both regimes; the truth of the paper's
# vLLM backend sits between them (EXPERIMENTS.md §Paper-validation).
L4_MAX_DRIVEN = CostModel(
    name="l4-max-driven",
    t_base=0.6,
    c_prefill=5e-5,
    c_decode_max=9.0e-3,
    c_decode_sum=1.5e-4,
)


def prefill_view(cost: CostModel) -> CostModel:
    """Phase-scoped view for a P/D *prefill* replica: a batch there only
    pays launch overhead + prompt processing. Decode coefficients are
    zeroed, so batch time is independent of output lengths — which the
    prefill stage never produces. The ``cached_tokens`` discount of
    ``step_time``/``batch_time`` applies unchanged: a prefill replica
    with a resident shared prefix prices only the uncached suffix."""
    return replace(cost, name=cost.name + "+prefill",
                   c_decode_max=0.0, c_decode_sum=0.0)


def decode_view(cost: CostModel) -> CostModel:
    """Phase-scoped view for a P/D *decode* replica: prompt tokens were
    already prefilled elsewhere (the KV arrives via the modeled
    transfer), so only launch overhead + decode terms remain. Both
    phases keep ``t_base``: disaggregation pays two batch launches per
    request — that overhead is part of its price."""
    return replace(cost, name=cost.name + "+decode", c_prefill=0.0)


def from_roofline(path: str, *, batch_capacity: int = 32,
                  name: Optional[str] = None) -> CostModel:
    """TPU projection from a decode-cell roofline JSON: the step-time
    lower bound of one decode iteration (batch B) gives c_decode.
    Prefill cost from the matching prefill cell if present."""
    with open(path) as f:
        rec = json.load(f)
    r = rec["roofline"]
    step = float(r["step_time_lower_bound_s"])
    # one decode step advances every active slot one token
    c_decode_sum = step / max(batch_capacity, 1)
    return CostModel(
        name=name or f"roofline:{rec['arch']}",
        t_base=0.005,
        c_prefill=step / (batch_capacity * 64),   # chunked-prefill share
        c_decode_max=0.0,                          # continuous batching:
        c_decode_sum=c_decode_sum,                 # cost ~ total tokens
        jitter_sigma=0.01,
    )
