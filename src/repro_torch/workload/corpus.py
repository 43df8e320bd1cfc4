"""Prompt corpus (Sec. III, IV-C): ~1180 unique prompts across four
semantic workload categories — short_qa, summary, technical, report.

The corpus is generated combinatorially from templates x topics (the
paper's corpus is likewise synthetic enterprise-IT traffic). Every
prompt carries a *latent verbosity* value — a per-prompt, deterministic
draw that models how much the serving model actually says in response.
Ground-truth output lengths are produced by :meth:`PromptSpec.sample_output`,
which combines:

  * the category's systematic generation ratio (~0.81 of T_base on
    average — this is exactly the runtime token drift the paper
    measures: static estimates consistently OVER-estimate, and learned
    bias converges to 0.79-0.84, Fig. 5),
  * the prompt's latent verbosity (heavier tail for report/technical,
    which makes report split medium/long at classification time, Fig. 4),
  * mild positive correlation with prompt length (longer prompts elicit
    longer answers — what F_input models at admission time),
  * per-request sampling noise (temperature).

Nothing in this module is visible to the scheduler: the estimator sees
only (category, tenant, prompt); observed lengths reach it strictly via
post-completion feedback, as in the paper.
"""

from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from ..core.request import Category

# ---------------------------------------------------------------------------
# Topic inventory — enterprise-IT flavoured, mirroring the paper's examples
# ("What is DNS?", "Summarize how Kubernetes schedules pods.", ...)
# ---------------------------------------------------------------------------

_TOPICS: Sequence[str] = (
    "DNS", "Kubernetes pod scheduling", "TCP congestion control", "BGP routing",
    "TLS certificate rotation", "OAuth2 token exchange", "container image layers",
    "service mesh sidecars", "etcd consensus", "load balancer health checks",
    "GPU memory paging", "KV-cache management", "continuous batching",
    "speculative decoding", "tensor parallelism", "pipeline parallelism",
    "gradient checkpointing", "mixed precision training", "collective all-reduce",
    "parameter servers", "RDMA networking", "NVMe-oF storage", "RAID rebuild",
    "log-structured merge trees", "B-tree indexes", "write-ahead logging",
    "MVCC snapshot isolation", "two-phase commit", "Raft leader election",
    "vector clocks", "CRDT convergence", "consistent hashing", "bloom filters",
    "cache eviction policies", "memory fragmentation", "NUMA locality",
    "cgroup CPU throttling", "eBPF tracing", "syscall batching", "io_uring",
    "zero-copy networking", "QUIC streams", "HTTP/3 prioritization",
    "CDN edge caching", "rate limiting algorithms", "circuit breakers",
    "blue-green deployment", "canary rollouts", "feature flags",
    "observability pipelines", "distributed tracing spans", "metrics cardinality",
    "alert fatigue", "incident runbooks", "postmortem culture",
    "chaos engineering", "capacity planning", "autoscaling policies",
    "spot instance preemption", "serverless cold starts", "WebAssembly sandboxing",
)

# Templates per category. short_qa is terse; summary embeds a synthetic
# passage reference; technical asks for explanation; report asks for a
# long-form structured document. Prompt *length* varies within category
# so F_input has signal to exploit.

_SHORT_QA_TEMPLATES = (
    "What is {t}?",
    "How does {t} work?",
    "When should teams use {t}?",
    "Define {t} in one paragraph.",
    "What problem does {t} solve?",
)

_SUMMARY_TEMPLATES = (
    "Summarize how {t} behaves under sustained production load, covering the main failure modes operators should monitor.",
    "Summarize the design of {t} for a new on-call engineer joining the platform team this quarter.",
    "Provide a concise summary of {t}, including when it is preferred over the common alternatives in large deployments.",
    "Summarize the operational trade-offs of {t} in a multi-region, multi-tenant cloud environment with strict latency SLOs.",
    "Summarize recent best practices around {t} and the migration steps legacy systems typically require.",
)

_TECHNICAL_TEMPLATES = (
    "Explain {t} in technical depth, including the underlying data structures, protocols, and the failure scenarios that arise under contention.",
    "Explain how {t} interacts with retries, timeouts, and backpressure in a distributed system, and how to reason about its consistency guarantees.",
    "Walk through the implementation details of {t}, covering the hot path, the slow path, and the instrumentation needed to debug production regressions.",
    "Explain the performance characteristics of {t}: asymptotic behavior, constant factors, memory traffic, and the tuning knobs that matter at scale.",
    "Describe {t} for a senior engineer audience, contrasting at least two real-world implementations and their divergent design decisions under load.",
)

_REPORT_TEMPLATES = (
    "Write a detailed incident report on the {t} outage.",
    "Write a full post-incident report covering {t}.",
    "Write a detailed incident report on a network outage involving {t}, summarizing affected services, the detection timeline, root cause analysis, remediation steps, and long-term action items for the infrastructure team.",
    "Write a comprehensive design review for adopting {t} across the organization, covering current architecture, proposed changes, capacity estimates, rollout phases, risk register, and success metrics.",
    "Write a detailed quarterly reliability report focused on {t}, including SLO attainment, error budgets consumed, major incidents, trend analysis, and prioritized engineering recommendations.",
    "Produce a full migration plan document for replacing the legacy implementation of {t}, with an executive summary, dependency inventory, phased timeline, rollback strategy, and cost analysis.",
)

_TEMPLATES: Dict[Category, Sequence[str]] = {
    Category.SHORT_QA: _SHORT_QA_TEMPLATES,
    Category.SUMMARY: _SUMMARY_TEMPLATES,
    Category.TECHNICAL: _TECHNICAL_TEMPLATES,
    Category.REPORT: _REPORT_TEMPLATES,
}

# ---------------------------------------------------------------------------
# Ground-truth generation behaviour (the hidden "model")
# ---------------------------------------------------------------------------
# mean_ratio: E[T_actual / T_base] — the systematic drift the estimator
#   must learn (paper Fig. 5: converges to 0.79-0.84).
# sigma: lognormal spread of per-prompt verbosity (report/technical are
#   heavier-tailed, producing the medium/long split in Fig. 4).
# len_exp: exponent coupling prompt length to output length.
_GENERATION_PROFILE: Dict[Category, Dict[str, float]] = {
    Category.SHORT_QA: dict(mean_ratio=0.855, sigma=0.12, len_exp=0.08),
    Category.SUMMARY: dict(mean_ratio=0.815, sigma=0.15, len_exp=0.10),
    Category.TECHNICAL: dict(mean_ratio=0.795, sigma=0.20, len_exp=0.12),
    Category.REPORT: dict(mean_ratio=0.825, sigma=0.22, len_exp=0.12),
}

# Reference prompt lengths per category for the length-coupling term
# (the corpus mean, in whitespace tokens).
_REF_PROMPT_LEN: Dict[Category, float] = {
    Category.SHORT_QA: 5.9,
    Category.SUMMARY: 17.3,
    Category.TECHNICAL: 21.7,
    Category.REPORT: 27.3,
}

# T_base mirror (must match estimator.DriftConfig defaults) — used only
# to scale ground-truth outputs; the scheduler never reads this.
_T_BASE: Dict[Category, float] = {
    Category.SHORT_QA: 64.0,
    Category.SUMMARY: 288.0,
    Category.TECHNICAL: 416.0,
    Category.REPORT: 600.0,
}


def generation_curve(category: Category) -> Tuple[float, float, float]:
    """Public view of the hidden generation behaviour for one category:
    ``(base, ref_prompt_len, len_exp)`` with ``base = T_base *
    mean_ratio``, so the expected ground-truth output of a prompt of
    length P is ``base * verbosity * (max(P,1)/ref)**len_exp`` before
    sampling noise. Used by the batched array trace generator
    (``workload.generator.VectorPlan``) to reproduce
    :meth:`PromptSpec.sample_output` marginals without per-request
    objects."""
    prof = _GENERATION_PROFILE[category]
    return (_T_BASE[category] * prof["mean_ratio"],
            _REF_PROMPT_LEN[category], prof["len_exp"])


def _stable_unit(s: str) -> float:
    """Deterministic uniform(0,1) from a string (prompt-latent seed)."""
    h = hashlib.sha256(s.encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


@dataclass(frozen=True)
class PromptSpec:
    """One corpus entry: text + hidden generation behaviour."""

    category: Category
    text: str
    prompt_tokens: int
    latent_verbosity: float  # multiplicative, lognormal around 1.0

    def sample_output(self, rng: random.Random, noise_sigma: float = 0.15,
                      max_tokens: int = 1024) -> int:
        """Draw the ground-truth generated length for one request."""
        prof = _GENERATION_PROFILE[self.category]
        base = _T_BASE[self.category] * prof["mean_ratio"]
        len_scale = (max(self.prompt_tokens, 1) / _REF_PROMPT_LEN[self.category]) ** prof["len_exp"]
        noise = math.exp(rng.gauss(0.0, noise_sigma) - 0.5 * noise_sigma ** 2)
        out = base * self.latent_verbosity * len_scale * noise
        return max(1, min(int(round(out)), max_tokens))


class Corpus:
    """Immutable prompt corpus with per-category views."""

    def __init__(self, prompts: Sequence[PromptSpec]):
        self.prompts: List[PromptSpec] = list(prompts)
        self.by_category: Dict[Category, List[PromptSpec]] = {c: [] for c in Category}
        for p in self.prompts:
            self.by_category[p.category].append(p)

    def __len__(self) -> int:
        return len(self.prompts)

    def sample(self, category: Category, rng: random.Random) -> PromptSpec:
        return rng.choice(self.by_category[category])


def build_corpus(target_size: int = 1180, pad_variants: int = 4) -> Corpus:
    """Build the ~1180-unique-prompt corpus (Sec. IV-C).

    60 topics x (5+5+5+4)=19 templates = 1140 base prompts; ``pad_variants``
    rephrased short_qa variants top it up to the target. Prompts are
    unique by construction; latent verbosity is a deterministic lognormal
    draw keyed on the prompt text, so the corpus is fully reproducible.
    """
    prompts: List[PromptSpec] = []
    seen = set()

    def add(category: Category, text: str) -> None:
        if text in seen:
            return
        seen.add(text)
        prof = _GENERATION_PROFILE[category]
        u = _stable_unit(text)
        # inverse-CDF lognormal via gauss on a second stable draw
        z = _stable_unit(text + "#z") * 2.0 - 1.0
        # Box-Muller-ish deterministic normal from two stable uniforms
        u1 = max(_stable_unit(text + "#u1"), 1e-12)
        u2 = _stable_unit(text + "#u2")
        g = math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)
        verbosity = math.exp(prof["sigma"] * g - 0.5 * prof["sigma"] ** 2)
        prompts.append(PromptSpec(
            category=category,
            text=text,
            prompt_tokens=len(text.split()),
            latent_verbosity=verbosity,
        ))

    for topic in _TOPICS:
        for cat, templates in _TEMPLATES.items():
            for tpl in templates:
                add(cat, tpl.format(t=topic))

    # Pad with extra short_qa phrasings to reach the target corpus size.
    extra_templates = (
        "Give a one-line answer: what is {t}?",
        "Briefly, why does {t} matter?",
        "Name the main alternative to {t}.",
        "Is {t} still relevant in 2026? Answer briefly.",
    )
    for tpl in extra_templates[:pad_variants]:
        for topic in _TOPICS:
            if len(prompts) >= target_size:
                break
            add(Category.SHORT_QA, tpl.format(t=topic))

    return Corpus(prompts[:target_size])
