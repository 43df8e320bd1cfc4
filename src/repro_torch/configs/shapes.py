"""The assigned input shapes and each cell's inputs as meta tensors.

Port of the JAX package's ``configs/shapes.py``. Four shapes per LM
architecture:

    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> prefill_step
    decode_32k   seq 32,768  global_batch 128   -> serve_step (1 token,
                                                   KV cache of seq_len)
    long_500k    seq 524,288 global_batch 1     -> serve_step

``long_500k`` needs a sub-quadratic decode state and is skipped for pure
full-attention architectures; ``shape_applicable`` encodes that rule.
``input_specs`` returns tensors on the ``meta`` device (shape and dtype,
no storage) for every model input, in place of JAX's
``ShapeDtypeStruct``s: the dry run runs the step on them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from ..models.config import ModelConfig

META = torch.device("meta")


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: Shape) -> Tuple[bool, str]:
    """(runnable, reason). long_500k needs sub-quadratic decode state."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: O(L) KV cache at 500k "
                       "context is infeasible; skipped per assignment")
    return True, ""


def cells_for(cfg: ModelConfig) -> List[Shape]:
    return [s for s in SHAPES.values() if shape_applicable(cfg, s)[0]]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _modality_specs(cfg: ModelConfig, batch: int) -> Dict:
    """Stub frontend inputs: precomputed frame/patch embeddings."""
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        return {"patches": _meta((batch, cfg.prefix_len, cfg.d_model), dtype)}
    if cfg.family == "encdec":
        return {"frames": _meta((batch, cfg.enc_seq, cfg.d_model), dtype)}
    return {}


def input_specs(cfg: ModelConfig, shape: Shape, *, cache_fn=None) -> Dict:
    """Meta-tensor stand-ins for one (arch x shape) cell.

    train:   {tokens, labels, modality...}
    prefill: {tokens, modality...}
    decode:  {tokens [B], pos scalar, cache tree, rng}

    The decode cache comes from the family's ``init_cache(...,
    device="meta")`` (pass ``cache_fn`` to override). ``rng`` is
    ``None``: it is the serve step's generator argument, and ``None``
    samples greedily, as the JAX dry run's temperature-0 step leaves its
    key unused.
    """
    B, L = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _meta((B, L), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _meta((B, L), torch.int32)
        specs.update(_modality_specs(cfg, B))
        return specs
    if cache_fn is None:
        from ..models.registry import get_api
        cache_fn = get_api(cfg).init_cache
    return {
        "tokens": _meta((B,), torch.int32),
        "pos": _meta((), torch.int32),
        "cache": cache_fn(cfg, B, L, device=META),
        "rng": None,
    }
