"""Family dispatch: the model API the serving engine calls.

Port of the JAX package's ``models/registry.py`` for the families the
port serves so far (the dense transformer):

    api = get_api(cfg)
    params = api.init(cfg, gen, device=...)
    logits, cache = api.prefill(cfg, params, tokens, max_len=...)
    logits, cache = api.decode_step(cfg, params, cache, tokens, pos)
    cache = api.init_cache(cfg, batch_size, max_len, device=...)

The JAX ``prefill`` takes a ``batch`` dict for the vlm and encdec
modality inputs; the dense family needs the tokens only, so the port's
takes them directly. ``forward`` comes with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

from . import transformer
from .config import ModelConfig


@dataclass(frozen=True)
class ModelApi:
    init: Callable[..., Dict]
    prefill: Callable[..., tuple]
    decode_step: Callable[..., tuple]
    init_cache: Callable[..., Dict]


_FAMILY_API: Dict[str, ModelApi] = {
    "dense": ModelApi(transformer.init, transformer.prefill,
                      transformer.decode_step, transformer.init_cache),
}


def get_api(cfg: ModelConfig) -> ModelApi:
    try:
        return _FAMILY_API[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"the port serves the dense family only; {cfg.family!r} is a "
            "later slice (ROADMAP.md, queue A)") from None
