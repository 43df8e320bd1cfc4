"""The chat corpus, frozen: a copy of the port's ``workload/corpus.py``
(templates x topics, per-prompt latent verbosity, the hidden generation
profile) with categories as plain strings, so the benchmark's traffic
does not move when the program's generator is edited.

:func:`build_corpus` gives the same prompts, token counts and
verbosities in the same order as the port's ``build_corpus``, and
:meth:`PromptSpec.sample_output` draws the same output lengths from the
same ``random.Random`` stream (``driftbench/tests`` holds them equal).
"""

from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass
from typing import Dict, List, Sequence

CATEGORIES = ("short_qa", "summary", "technical", "report")

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

_TEMPLATES: Dict[str, Sequence[str]] = {
    "short_qa": _SHORT_QA_TEMPLATES,
    "summary": _SUMMARY_TEMPLATES,
    "technical": _TECHNICAL_TEMPLATES,
    "report": _REPORT_TEMPLATES,
}

# ---------------------------------------------------------------------------
# Ground-truth generation behaviour (the hidden "model")
# ---------------------------------------------------------------------------
# mean_ratio: E[T_actual / T_base] — the systematic drift the estimator
#   must learn (paper Fig. 5: converges to 0.79-0.84).
# sigma: lognormal spread of per-prompt verbosity (report/technical are
#   heavier-tailed, producing the medium/long split in Fig. 4).
# len_exp: exponent coupling prompt length to output length.
_GENERATION_PROFILE: Dict[str, Dict[str, float]] = {
    "short_qa": dict(mean_ratio=0.855, sigma=0.12, len_exp=0.08),
    "summary": dict(mean_ratio=0.815, sigma=0.15, len_exp=0.10),
    "technical": dict(mean_ratio=0.795, sigma=0.20, len_exp=0.12),
    "report": dict(mean_ratio=0.825, sigma=0.22, len_exp=0.12),
}

# Reference prompt lengths per category for the length-coupling term
# (the corpus mean, in whitespace tokens).
_REF_PROMPT_LEN: Dict[str, float] = {
    "short_qa": 5.9,
    "summary": 17.3,
    "technical": 21.7,
    "report": 27.3,
}

# T_base mirror (must match estimator.DriftConfig defaults) — used only
# to scale ground-truth outputs; the scheduler never reads this.
_T_BASE: Dict[str, float] = {
    "short_qa": 64.0,
    "summary": 288.0,
    "technical": 416.0,
    "report": 600.0,
}


def _stable_unit(s: str) -> float:
    """Deterministic uniform(0,1) from a string (prompt-latent seed)."""
    h = hashlib.sha256(s.encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


@dataclass(frozen=True)
class PromptSpec:
    """One corpus entry: text + hidden generation behaviour."""

    category: str
    text: str
    prompt_tokens: int
    latent_verbosity: float

    def sample_output(self, rng: random.Random, noise_sigma: float,
                      max_tokens: int) -> int:
        """Draw the ground-truth generated length for one request."""
        prof = _GENERATION_PROFILE[self.category]
        base = _T_BASE[self.category] * prof["mean_ratio"]
        len_scale = (max(self.prompt_tokens, 1)
                     / _REF_PROMPT_LEN[self.category]) ** prof["len_exp"]
        noise = math.exp(rng.gauss(0.0, noise_sigma) - 0.5 * noise_sigma ** 2)
        out = base * self.latent_verbosity * len_scale * noise
        return max(1, min(int(round(out)), max_tokens))


def build_corpus(target_size: int = 1180, pad_variants: int = 4
                 ) -> Dict[str, List[PromptSpec]]:
    """The ~1180 prompts by category, each list in corpus order."""
    prompts: List[PromptSpec] = []
    seen = set()

    def add(category: str, text: str) -> None:
        if text in seen:
            return
        seen.add(text)
        prof = _GENERATION_PROFILE[category]
        u1 = max(_stable_unit(text + "#u1"), 1e-12)
        u2 = _stable_unit(text + "#u2")
        g = math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)
        verbosity = math.exp(prof["sigma"] * g - 0.5 * prof["sigma"] ** 2)
        prompts.append(PromptSpec(category, text, len(text.split()),
                                  verbosity))

    for topic in _TOPICS:
        for cat, templates in _TEMPLATES.items():
            for tpl in templates:
                add(cat, tpl.format(t=topic))
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
            add("short_qa", tpl.format(t=topic))
    by_category: Dict[str, List[PromptSpec]] = {c: [] for c in CATEGORIES}
    for p in prompts[:target_size]:
        by_category[p.category].append(p)
    return by_category
