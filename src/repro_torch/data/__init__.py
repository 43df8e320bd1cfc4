"""Data pipeline of the port's trainer (a copy of the JAX package's
``data/``, numpy only)."""

from .pipeline import CorpusTextDataset, SyntheticLMDataset, make_dataset

__all__ = ["CorpusTextDataset", "SyntheticLMDataset", "make_dataset"]
