"""The one traffic generator: request content and open-loop arrivals
from a mix's parameters (``driftbench/traffic/<mix>.json``).

Content is Algorithm 1 of the paper as the port's
``workload/generator.py`` draws it (weighted category, then tenant,
then a corpus prompt, then its output length, all from one
``random.Random`` stream), written to plain records. Arrivals are new
here: the port's plan ties its second burst to the calibration drain.

Every seed of a cell gets the same work. The records and the
inter-arrival gaps are drawn once from the mix's ``pool_seed``; the
run's seed permutes both. So each seed serves the same multiset of
prompts, output lengths and gaps, in another order, and the spread
between seeds is the system's and not the sampler's.

Arrival processes (``arrivals.process``):

* ``poisson``: exponential gaps at the cell's rate.
* ``onoff``: Poisson at twice the cell's rate while on, nothing while
  off, on and off for ``period_s`` seconds each (on first), so the mean
  over whole periods is the cell's rate. The seed permutes whole bursts
  (each keeps its arrivals), so every seed sees the same bursts in
  another order.

Shared prefixes (``content.shared_prefix_tokens``, 0 or absent for
none): as the port's generator, each request joins one of
``prefix_groups_per_tenant`` groups of its tenant and its prompt grows
by that many tokens, which the engine lays out as the group's prefix
when it has a prefix cache.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .corpus import CATEGORIES, build_corpus

TIERS = ("premium", "standard", "batch")


@dataclass(frozen=True)
class Record:
    """One request as the harness hands it to the program."""

    due: float                 # seconds from the start of the traffic
    tenant: str
    category: str
    prompt: str
    prompt_tokens: int
    max_tokens: int
    true_output_tokens: int
    prefix_group: Optional[Tuple[str, int]] = None
    shared_prefix_tokens: int = 0


def draw_content(content: Dict, n: int, seed: int) -> List[Dict]:
    """``n`` request contents from ``random.Random(seed)``, in the order
    the port's ``WorkloadGenerator.make_request`` draws them."""
    corpus = build_corpus()
    cat_w = content["category_weights"]
    tier_w = content["tenant_weights"]
    cats = [c for c in CATEGORIES if c in cat_w]
    tiers = [t for t in TIERS if t in tier_w]
    scale = float(content.get("prompt_tokens_scale", 1.0))
    sigma = float(content["output_noise_sigma"])
    max_tokens = int(content["max_tokens"])
    shared = int(content.get("shared_prefix_tokens", 0))
    groups = max(int(content.get("prefix_groups_per_tenant", 4)), 1)
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        category = rng.choices(cats, weights=[cat_w[c] for c in cats])[0]
        tenant = rng.choices(tiers, weights=[tier_w[t] for t in tiers])[0]
        spec = rng.choice(corpus[category])
        true_out = spec.sample_output(rng, noise_sigma=sigma,
                                      max_tokens=max_tokens)
        group = (tenant, rng.randrange(groups)) if shared > 0 else None
        out.append(dict(tenant=tenant, category=category, prompt=spec.text,
                        prompt_tokens=max(1, round(spec.prompt_tokens * scale))
                        + shared, max_tokens=max_tokens,
                        true_output_tokens=true_out, prefix_group=group,
                        shared_prefix_tokens=shared))
    return out


def _gaps(rate: float, span: float, seed: int) -> np.ndarray:
    """Exponential gaps at ``rate`` whose running sum stays within
    ``span`` (all of them: a permutation keeps every arrival inside)."""
    rng = np.random.default_rng(seed)
    n = int(rate * span * 1.5) + 64
    gaps = rng.exponential(1.0 / rate, size=n)
    while gaps.sum() <= span:
        gaps = np.concatenate([gaps, rng.exponential(1.0 / rate, size=n)])
    keep = int(np.searchsorted(np.cumsum(gaps), span, side="right"))
    return gaps[:keep]


def plan(traffic: Dict, rate: float, span: float, seed: int) -> List[Record]:
    """The arrivals due in ``[0, span)`` seconds for a cell at ``rate``
    requests a second, in due order, permuted by ``seed``."""
    arr = traffic["arrivals"]
    pool_seed = int(traffic["pool_seed"])
    process = arr["process"]
    if process == "poisson":
        gaps = _gaps(rate, span, pool_seed)
        order = np.random.default_rng(seed)
        due = np.cumsum(gaps[order.permutation(len(gaps))])
    elif process == "onoff":
        period = float(arr["period_s"])
        peak = 2.0 * rate
        n_on = int(np.ceil(span / (2 * period)))
        t_on = np.cumsum(_gaps(peak, n_on * period, pool_seed))
        burst = np.floor(t_on / period).astype(int)
        order = np.random.default_rng(seed)
        slot = order.permutation(n_on)          # burst k goes to slot[k]
        due = np.sort(slot[burst] * 2 * period + (t_on - burst * period))
    else:
        raise ValueError(f"unknown arrival process {process!r}")
    n = len(due)
    contents = draw_content(traffic["content"], n, pool_seed)
    picks = order.permutation(n)
    return [Record(due=float(due[i]), **contents[int(picks[i])])
            for i in range(n) if due[i] < span]


def summary(records: Sequence[Record]) -> Dict[str, float]:
    """Counts and length percentiles of a plan (for the run's log)."""
    outs = np.array([r.true_output_tokens for r in records] or [0])
    prompts = np.array([r.prompt_tokens for r in records] or [0])
    return {"requests": len(records),
            "output_tokens_mean": float(outs.mean()),
            "output_tokens_p95": float(np.percentile(outs, 95)),
            "output_tokens_max": int(outs.max()),
            "prompt_tokens_max": int(prompts.max())}
