"""Workload generation (Sec. II-B): heterogeneous multi-tenant inference
traffic over a ~1180-unique-prompt corpus spanning four semantic
categories, with weighted probabilistic selection and burst arrival
processes capable of saturating the GPU inference queues."""

from .corpus import Corpus, PromptSpec, build_corpus
from .generator import (ArrivalPlan, GeneratorConfig, WorkloadGenerator,
                        cluster_stress_config)

__all__ = [
    "ArrivalPlan", "Corpus", "GeneratorConfig", "PromptSpec",
    "WorkloadGenerator", "build_corpus", "cluster_stress_config",
]
