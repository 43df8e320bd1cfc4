"""Multi-tenant workload generator (Sec. II-B, Algorithm 1).

Produces the paper's experimental traffic:

* 3000 requests per run — 1000 calibration + 2000 stress (Sec. II-G),
* weighted probabilistic category selection (Algorithm 1),
* tenant tier assignment (Premium / Standard / Batch),
* burst arrival processes that saturate the GPU queues (the paper uses
  a 50-client thread pool; we model the resulting arrival pattern as two
  open-loop Poisson bursts separated by a drain gap, which reproduces
  the two queue-buildup phases of Fig. 6).

The generator is deterministic given its seed. Ground-truth output
lengths are attached to each request (hidden from the scheduler) so the
simulator / engine can "generate" them.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.request import Category, Request, TenantTier
from .corpus import Corpus, build_corpus, generation_curve

# Stable integer codes for the array representation (VectorPlan and the
# vectorized simulator core index per-category/per-tier tables by these).
CATEGORY_ORDER: Tuple[Category, ...] = tuple(Category)
TIER_ORDER: Tuple[TenantTier, ...] = tuple(TenantTier)
_CAT_CODE = {c: i for i, c in enumerate(CATEGORY_ORDER)}


@dataclass(frozen=True)
class GeneratorConfig:
    """Traffic composition (paper Sec. III-B defaults)."""

    total_requests: int = 3000
    calibration_requests: int = 1000          # Sec. II-G: 1:2 split
    # Algorithm 1 weighted category distribution.
    category_weights: Mapping[Category, float] = field(default_factory=lambda: {
        Category.SHORT_QA: 0.35,
        Category.SUMMARY: 0.25,
        Category.TECHNICAL: 0.25,
        Category.REPORT: 0.15,
    })
    # Tenant mix.
    tenant_weights: Mapping[TenantTier, float] = field(default_factory=lambda: {
        TenantTier.PREMIUM: 0.30,
        TenantTier.STANDARD: 0.40,
        TenantTier.BATCH: 0.30,
    })
    # Arrival process (paper Sec. II-G / IV-D): two BURSTS. The 50-client
    # thread pool floods the gateway, so each phase is a near-instant
    # queue spike; the stress burst is released only after the
    # calibration phase drains ("After calibration completes, the
    # remaining 2000 requests are submitted"). ``*_rate`` is the
    # gateway ingestion rate of each burst.
    calibration_rate: float = 18.0
    stress_rate: float = 18.0
    max_tokens: int = 1024                     # user-configured cap
    output_noise_sigma: float = 0.10          # per-request sampling noise
    # scale factor on prompt token counts (the corpus prompts are terse,
    # 3-32 tokens; chunked-prefill experiments need RAG/agent-scale
    # prompts of hundreds of tokens, modeled by scaling the counts while
    # keeping the corpus text/verbosity structure)
    prompt_tokens_scale: float = 1.0
    # --- shared-prefix population (radix KV-cache workloads) ---
    # Real multi-tenant chat/RAG traffic front-loads every prompt with
    # a tenant system prompt / retrieval template. Model that: each
    # request draws one of ``prefix_groups_per_tenant`` groups for its
    # tenant tier and gains ``shared_prefix_tokens`` extra prompt
    # tokens (NOT scaled by prompt_tokens_scale — system prompts are a
    # fixed population, not per-request verbosity) tagged as shareable
    # (Request.prefix_group / shared_prefix_tokens). 0 disables the
    # mechanism and leaves the arrival plan bit-identical to earlier
    # protocol versions (no extra rng draws).
    shared_prefix_tokens: int = 0
    prefix_groups_per_tenant: int = 4
    seed: int = 0


@dataclass
class ArrivalPlan:
    """Materialised arrival schedule.

    ``calibration``: absolute arrival times from t=0.
    ``stress``: offsets *relative to the stress-release instant* (the
    executor — simulator or engine — releases the stress burst once
    every calibration request has completed, per Sec. II-G).
    """

    calibration: List[Tuple[float, Request]]
    stress: List[Tuple[float, Request]]
    config: GeneratorConfig

    def __iter__(self) -> Iterator[Tuple[float, Request]]:
        """All arrivals with stress offsets appended after the last
        calibration arrival (open-loop view, used by tests)."""
        yield from self.calibration
        t0 = self.calibration[-1][0] if self.calibration else 0.0
        for dt, r in self.stress:
            yield (t0 + dt, r)

    def __len__(self) -> int:
        return len(self.calibration) + len(self.stress)


def cluster_stress_config(n_replicas: int, *,
                          total_requests: int = 1200,
                          per_replica_rate: float = 8.0,
                          seed: int = 0,
                          max_tokens: int = 1024,
                          prompt_tokens_scale: float = 1.0,
                          shared_prefix_tokens: int = 0,
                          prefix_groups_per_tenant: int = 4
                          ) -> GeneratorConfig:
    """Heterogeneous cluster stress traffic (multi-replica arrival plan).

    Same two-burst protocol as the paper, with (a) arrival rates scaled
    to the replica count so the cluster — not one worker — is what
    saturates, and (b) a heavier-tailed category mix (more technical /
    report traffic) so request sizes are genuinely heterogeneous: the
    regime where routing policy choice matters.
    """
    return GeneratorConfig(
        total_requests=total_requests,
        calibration_requests=total_requests // 3,
        category_weights={
            Category.SHORT_QA: 0.30,
            Category.SUMMARY: 0.20,
            Category.TECHNICAL: 0.25,
            Category.REPORT: 0.25,
        },
        calibration_rate=0.75 * per_replica_rate * n_replicas,
        stress_rate=per_replica_rate * n_replicas,
        max_tokens=max_tokens,
        prompt_tokens_scale=prompt_tokens_scale,
        shared_prefix_tokens=shared_prefix_tokens,
        prefix_groups_per_tenant=prefix_groups_per_tenant,
        seed=seed,
    )


class WorkloadGenerator:
    """Algorithm 1, deterministic."""

    def __init__(self, config: Optional[GeneratorConfig] = None,
                 corpus: Optional[Corpus] = None) -> None:
        self.config = config or GeneratorConfig()
        self.corpus = corpus or build_corpus()
        self._cats = list(self.config.category_weights.keys())
        self._cat_w = list(self.config.category_weights.values())
        self._tiers = list(self.config.tenant_weights.keys())
        self._tier_w = list(self.config.tenant_weights.values())

    # ------------------------------------------------------------------
    def make_request(self, rng: random.Random) -> Request:
        cfg = self.config
        category = rng.choices(self._cats, weights=self._cat_w)[0]
        tenant = rng.choices(self._tiers, weights=self._tier_w)[0]
        spec = self.corpus.sample(category, rng)
        true_out = spec.sample_output(
            rng, noise_sigma=cfg.output_noise_sigma, max_tokens=cfg.max_tokens
        )
        prefix_group = None
        shared = 0
        if cfg.shared_prefix_tokens > 0:
            shared = cfg.shared_prefix_tokens
            prefix_group = (tenant.label,
                            rng.randrange(max(cfg.prefix_groups_per_tenant,
                                              1)))
        return Request(
            tenant=tenant,
            category=category,
            prompt=spec.text,
            prompt_tokens=max(1, round(spec.prompt_tokens
                                       * cfg.prompt_tokens_scale)) + shared,
            max_tokens=cfg.max_tokens,
            true_output_tokens=true_out,
            prefix_group=prefix_group,
            shared_prefix_tokens=shared,
        )

    def plan(self, seed: Optional[int] = None) -> ArrivalPlan:
        """Materialise the two-burst arrival schedule."""
        cfg = self.config
        rng = random.Random(cfg.seed if seed is None else seed)

        t = 0.0
        calibration: List[Tuple[float, Request]] = []
        n_cal = min(cfg.calibration_requests, cfg.total_requests)
        for _ in range(n_cal):
            t += rng.expovariate(cfg.calibration_rate)
            calibration.append((t, self.make_request(rng)))

        t = 0.0
        stress: List[Tuple[float, Request]] = []
        for _ in range(cfg.total_requests - n_cal):
            t += rng.expovariate(cfg.stress_rate)
            stress.append((t, self.make_request(rng)))

        return ArrivalPlan(calibration=calibration, stress=stress, config=cfg)

    # ------------------------------------------------------------------
    def category_histogram(self, plan: ArrivalPlan) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _, r in plan:
            out[r.category.value] = out.get(r.category.value, 0) + 1
        return out


# ---------------------------------------------------------------------------
# Flat-array trace representation (vectorized simulator core)
# ---------------------------------------------------------------------------
@dataclass
class VectorPlan:
    """The two-burst arrival schedule as flat numpy arrays.

    Row ``i`` is one request. The first ``n_calibration`` rows carry
    *absolute* arrival times from t=0; the remaining rows carry offsets
    relative to the stress-release instant (identical convention to
    :class:`ArrivalPlan`). Rows are in arrival order within each burst.

    Two constructors:

    * :meth:`from_plan` converts an object :class:`ArrivalPlan`
      losslessly (same requests, same ``req_id``s) — this is what the
      differential parity suite uses so both engines consume the exact
      same trace.
    * :meth:`generate` draws the trace directly into arrays with a
      ``numpy.random.Generator`` — *distribution*-equivalent to
      :class:`WorkloadGenerator` (same category/tenant mixes, corpus
      marginals, output-length law, Poisson bursts) but NOT
      bit-identical to it (different RNG stream). Use it for 10^5+
      sweeps where materialising Request objects is the bottleneck.
    """

    n_calibration: int
    arrival: np.ndarray              # float64 [n]
    tenant: np.ndarray               # int8    [n] TenantTier values
    category: np.ndarray             # int8    [n] index into CATEGORY_ORDER
    prompt_tokens: np.ndarray        # int32   [n]
    max_tokens: np.ndarray           # int32   [n]
    true_output_tokens: np.ndarray   # int32   [n]
    shared_prefix_tokens: np.ndarray  # int32  [n]
    prefix_gid: np.ndarray           # int32   [n]; -1 = no shareable prefix
    req_id: np.ndarray               # int64   [n]
    group_table: List[tuple]         # gid -> hashable prefix_group key
    config: GeneratorConfig

    def __len__(self) -> int:
        return int(self.arrival.shape[0])

    # -- lossless conversion from the object plan (parity path) --------
    @classmethod
    def from_plan(cls, plan: ArrivalPlan) -> "VectorPlan":
        rows = list(plan.calibration) + list(plan.stress)
        n = len(rows)
        groups: Dict[tuple, int] = {}
        table: List[tuple] = []
        gid = np.full(n, -1, dtype=np.int32)
        out = cls(
            n_calibration=len(plan.calibration),
            arrival=np.fromiter((t for t, _ in rows), dtype=np.float64,
                                count=n),
            tenant=np.fromiter((int(r.tenant) for _, r in rows),
                               dtype=np.int8, count=n),
            category=np.fromiter((_CAT_CODE[r.category] for _, r in rows),
                                 dtype=np.int8, count=n),
            prompt_tokens=np.fromiter((r.prompt_tokens for _, r in rows),
                                      dtype=np.int32, count=n),
            max_tokens=np.fromiter((r.max_tokens for _, r in rows),
                                   dtype=np.int32, count=n),
            true_output_tokens=np.fromiter(
                (r.true_output_tokens for _, r in rows), dtype=np.int32,
                count=n),
            shared_prefix_tokens=np.fromiter(
                (r.shared_prefix_tokens for _, r in rows), dtype=np.int32,
                count=n),
            prefix_gid=gid,
            req_id=np.fromiter((r.req_id for _, r in rows), dtype=np.int64,
                               count=n),
            group_table=table,
            config=plan.config,
        )
        for i, (_, r) in enumerate(rows):
            if r.prefix_group is not None:
                g = groups.setdefault(r.prefix_group, len(table))
                if g == len(table):
                    table.append(r.prefix_group)
                gid[i] = g
        return out

    # -- batched array generation (scale path) -------------------------
    @classmethod
    def generate(cls, config: Optional[GeneratorConfig] = None,
                 seed: Optional[int] = None,
                 corpus: Optional[Corpus] = None) -> "VectorPlan":
        cfg = config or GeneratorConfig()
        corpus = corpus or build_corpus()
        rng = np.random.default_rng(cfg.seed if seed is None else seed)
        n = cfg.total_requests
        n_cal = min(cfg.calibration_requests, n)

        cats = list(cfg.category_weights.keys())
        cat_w = np.asarray(list(cfg.category_weights.values()), dtype=float)
        tiers = list(cfg.tenant_weights.keys())
        tier_w = np.asarray(list(cfg.tenant_weights.values()), dtype=float)
        cat_pick = rng.choice(len(cats), size=n, p=cat_w / cat_w.sum())
        tier_pick = rng.choice(len(tiers), size=n, p=tier_w / tier_w.sum())

        category = np.fromiter((_CAT_CODE[c] for c in cats),
                               dtype=np.int8)[cat_pick]
        tenant = np.fromiter((int(t) for t in tiers),
                             dtype=np.int8)[tier_pick]

        # corpus entry draw: uniform within the picked category, exactly
        # like Corpus.sample, but over per-category token/verbosity arrays
        prompt_base = np.zeros(n, dtype=np.float64)
        verbosity = np.zeros(n, dtype=np.float64)
        base = np.zeros(n, dtype=np.float64)
        ref_len = np.zeros(n, dtype=np.float64)
        len_exp = np.zeros(n, dtype=np.float64)
        for k, cat in enumerate(cats):
            mask = cat_pick == k
            m = int(mask.sum())
            if m == 0:
                continue
            entries = corpus.by_category[cat]
            pts = np.asarray([p.prompt_tokens for p in entries], dtype=float)
            verbs = np.asarray([p.latent_verbosity for p in entries],
                               dtype=float)
            pick = rng.integers(0, len(entries), size=m)
            prompt_base[mask] = pts[pick]
            verbosity[mask] = verbs[pick]
            b, r, e = generation_curve(cat)
            base[mask], ref_len[mask], len_exp[mask] = b, r, e

        sigma = cfg.output_noise_sigma
        noise = np.exp(rng.normal(0.0, sigma, size=n) - 0.5 * sigma ** 2)
        raw_out = (base * verbosity
                   * (np.maximum(prompt_base, 1.0) / ref_len) ** len_exp
                   * noise)
        true_out = np.clip(np.rint(raw_out), 1,
                           cfg.max_tokens).astype(np.int32)

        shared = int(cfg.shared_prefix_tokens)
        prompt_tokens = (np.maximum(
            1, np.rint(prompt_base * cfg.prompt_tokens_scale)).astype(
                np.int32) + shared)

        gid = np.full(n, -1, dtype=np.int32)
        table: List[tuple] = []
        if shared > 0:
            g_per = max(cfg.prefix_groups_per_tenant, 1)
            g = rng.integers(0, g_per, size=n).astype(np.int32)
            gid = tenant.astype(np.int32) * g_per + g
            table = [(tier.label, j) for tier in TIER_ORDER
                     for j in range(g_per)]

        arrival = np.zeros(n, dtype=np.float64)
        if n_cal:
            arrival[:n_cal] = np.cumsum(
                rng.exponential(1.0 / cfg.calibration_rate, size=n_cal))
        if n - n_cal:
            arrival[n_cal:] = np.cumsum(
                rng.exponential(1.0 / cfg.stress_rate, size=n - n_cal))

        from ..core.request import _REQ_IDS
        req_id = np.fromiter((next(_REQ_IDS) for _ in range(n)),
                             dtype=np.int64, count=n)
        return cls(n_calibration=n_cal, arrival=arrival, tenant=tenant,
                   category=category, prompt_tokens=prompt_tokens,
                   max_tokens=np.full(n, cfg.max_tokens, dtype=np.int32),
                   true_output_tokens=true_out,
                   shared_prefix_tokens=np.full(n, shared, dtype=np.int32),
                   prefix_gid=gid, req_id=req_id, group_table=table,
                   config=cfg)

    # -- materialisation back into the object world --------------------
    def to_arrival_plan(self) -> ArrivalPlan:
        """Build the equivalent object :class:`ArrivalPlan` (fresh
        Request objects carrying this plan's ``req_id``s), so the object
        engine can run the exact same trace — the benchmark's honest
        same-input oracle arm."""
        rows: List[Tuple[float, Request]] = []
        for i in range(len(self)):
            g = int(self.prefix_gid[i])
            r = Request(
                tenant=TenantTier(int(self.tenant[i])),
                category=CATEGORY_ORDER[int(self.category[i])],
                prompt_tokens=int(self.prompt_tokens[i]),
                max_tokens=int(self.max_tokens[i]),
                true_output_tokens=int(self.true_output_tokens[i]),
                prefix_group=(self.group_table[g] if g >= 0 else None),
                shared_prefix_tokens=int(self.shared_prefix_tokens[i]),
            )
            r.req_id = int(self.req_id[i])
            rows.append((float(self.arrival[i]), r))
        return ArrivalPlan(calibration=rows[:self.n_calibration],
                           stress=rows[self.n_calibration:],
                           config=self.config)
