"""Deterministic, shardable LM data pipelines.

Two sources:

* :class:`SyntheticLMDataset` — procedurally generated token streams
  with learnable structure (affine next-token rule mixed with repeated
  motifs). Loss visibly decreases within tens of steps, which makes the
  end-to-end training example / convergence tests meaningful without
  shipping a corpus.
* :class:`CorpusTextDataset` — byte-level tokenisation of the workload
  corpus prompts (the paper's own text), packed into fixed-length
  sequences.

Both are stateless-indexable: ``batch(step, rank, n_ranks)`` returns
the same arrays for the same coordinates — exactly what a restarted or
elastically re-scaled data-parallel trainer needs (no iterator state in
checkpoints; the step counter is the state).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..models.config import ModelConfig


def _seed_for(tag: str, step: int, rank: int) -> int:
    h = hashlib.sha256(f"{tag}:{step}:{rank}".encode()).digest()
    return int.from_bytes(h[:8], "big") % (2**63)


@dataclass(frozen=True)
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    batch_per_rank: int
    motif_len: int = 16
    tag: str = "synthetic-lm"

    def batch(self, step: int, rank: int = 0, n_ranks: int = 1) -> Dict:
        rng = np.random.default_rng(_seed_for(self.tag, step, rank))
        B, L, V = self.batch_per_rank, self.seq_len, self.vocab
        # affine progressions: x_{t+1} = (x_t + delta) % V, per row
        start = rng.integers(0, V, (B, 1))
        delta = rng.integers(1, 7, (B, 1))
        seq = (start + delta * np.arange(L + 1)[None, :]) % V
        # overwrite random windows with repeated motifs (copy task)
        motif = rng.integers(0, V, (B, self.motif_len))
        for b in range(B):
            at = rng.integers(0, max(L - 2 * self.motif_len, 1))
            seq[b, at:at + self.motif_len] = motif[b]
            seq[b, at + self.motif_len:at + 2 * self.motif_len] = motif[b]
        tokens = seq[:, :-1].astype(np.int32)
        labels = seq[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}


@dataclass(frozen=True)
class CorpusTextDataset:
    vocab: int
    seq_len: int
    batch_per_rank: int
    tag: str = "corpus-text"

    def _bytes(self) -> np.ndarray:
        from ..workload.corpus import build_corpus
        text = "\n".join(p.text for p in build_corpus().prompts)
        arr = np.frombuffer(text.encode(), dtype=np.uint8).astype(np.int32)
        return arr % self.vocab

    def batch(self, step: int, rank: int = 0, n_ranks: int = 1) -> Dict:
        stream = self._bytes()
        B, L = self.batch_per_rank, self.seq_len
        need = B * (L + 1)
        offset = (_seed_for(self.tag, step, rank) % max(
            len(stream) - need, 1))
        flat = np.take(stream, np.arange(offset, offset + need),
                       mode="wrap")
        seq = flat.reshape(B, L + 1)
        return {"tokens": seq[:, :-1].copy(), "labels": seq[:, 1:].copy()}


def make_dataset(name: str, cfg: ModelConfig, seq_len: int,
                 batch_per_rank: int):
    if name == "synthetic":
        return SyntheticLMDataset(cfg.vocab, seq_len, batch_per_rank)
    if name == "corpus":
        return CorpusTextDataset(cfg.vocab, seq_len, batch_per_rank)
    raise ValueError(f"unknown dataset {name!r}")


def attach_modality_stubs(cfg: ModelConfig, batch: Dict,
                          rng: Optional[np.random.Generator] = None) -> Dict:
    """Add the stub frontend inputs the vlm/encdec families expect."""
    rng = rng or np.random.default_rng(0)
    B = batch["tokens"].shape[0]
    if cfg.family == "vlm":
        batch["patches"] = (0.02 * rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = (0.02 * rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    return batch
