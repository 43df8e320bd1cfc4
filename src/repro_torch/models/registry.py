"""Family dispatch: the model API the trainer and the serving engine
call.

Port of the JAX package's ``models/registry.py`` for the families the
port runs so far: the dense transformer (training and both serving
caches) and the SSM family, Mamba-2 (training only):

    api = get_api(cfg)
    params = api.init(cfg, gen, device=...)
    logits, aux = api.forward(cfg, params, batch, remat=..., impl=...)
    logits, cache = api.prefill(cfg, params, tokens, max_len=...)
    logits, cache = api.decode_step(cfg, params, cache, tokens, pos)
    cache = api.init_cache(cfg, batch_size, max_len, device=...)

``forward`` takes a ``batch`` dict, as in JAX (the vlm and encdec
modality inputs travel in it); the dense family's ``prefill`` takes the
tokens directly. The SSM family has no serving entries (``None``) until
the SSM serving slice (ROADMAP.md, A8): :func:`get_serving_api` refuses
it, and every family the port does not run, up front.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

from . import mamba2, transformer
from .config import ModelConfig


@dataclass(frozen=True)
class ModelApi:
    init: Callable[..., Dict]
    forward: Callable[..., tuple]
    prefill: Optional[Callable[..., tuple]] = None
    decode_step: Optional[Callable[..., tuple]] = None
    init_cache: Optional[Callable[..., Dict]] = None


def _later(family: str, what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"the port does not {what} the {family!r} family yet; it is a later "
        f"slice (ROADMAP.md, {item})")


def _tf_forward(cfg, params, batch, *, remat=False, impl="auto"):
    if batch.get("patches") is not None:
        raise _later(cfg.family, "train", "A7")
    return transformer.forward(cfg, params, batch["tokens"], remat=remat,
                               impl=impl)


def _mamba_forward(cfg, params, batch, *, remat=False, impl="auto"):
    return mamba2.forward(cfg, params, batch["tokens"], remat=remat,
                          impl=impl)


_FAMILY_API: Dict[str, ModelApi] = {
    "dense": ModelApi(transformer.init, _tf_forward, transformer.prefill,
                      transformer.decode_step, transformer.init_cache),
    "ssm": ModelApi(mamba2.init, _mamba_forward),
}


def get_api(cfg: ModelConfig) -> ModelApi:
    try:
        return _FAMILY_API[cfg.family]
    except KeyError:
        raise _later(cfg.family, "run", "queue A") from None


def get_serving_api(cfg: ModelConfig) -> ModelApi:
    """``get_api`` for a family the serving engine can run."""
    api = get_api(cfg)
    if api.prefill is None:
        raise _later(cfg.family, "serve", "A8")
    return api
