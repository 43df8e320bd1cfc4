"""Family dispatch: the model API the trainer and the serving engine
call.

Port of the JAX package's ``models/registry.py``, for all six of its
families, each trained and served: the transformer's dense, moe and vlm
families (both engine caches), the encoder-decoder (whisper), the SSM
family (Mamba-2) and the hybrid (zamba2), the last three on the
slot-ring cache:

    api = get_api(cfg)
    params = api.init(cfg, gen, device=...)
    logits, aux = api.forward(cfg, params, batch, remat=..., impl=...)
    logits, cache = api.prefill(cfg, params, batch, max_len=...)
    logits, cache = api.decode_step(cfg, params, cache, tokens, pos)
    cache = api.init_cache(cfg, batch_size, max_len, device=...)
    params = abstract_params(cfg)    # the same tree on "meta"

``forward`` and ``prefill`` take a ``batch`` dict, as in JAX: the
tokens, and the modality inputs that the adapters route to the family's
keyword (vlm ``patches``, encdec ``frames``). An unknown family raises
``ValueError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

from . import encdec, hybrid, mamba2, transformer
from .config import ModelConfig


@dataclass(frozen=True)
class ModelApi:
    init: Callable[..., Dict]
    forward: Callable[..., tuple]
    prefill: Callable[..., tuple]
    decode_step: Callable[..., tuple]
    init_cache: Callable[..., Dict]


def _tf_forward(cfg, params, batch, *, remat=False, impl="auto"):
    return transformer.forward(cfg, params, batch["tokens"],
                               patches=batch.get("patches"), remat=remat,
                               impl=impl)


def _tf_prefill(cfg, params, batch, *, max_len=None, impl="auto"):
    return transformer.prefill(cfg, params, batch["tokens"],
                               patches=batch.get("patches"),
                               max_len=max_len, impl=impl)


def _mamba_forward(cfg, params, batch, *, remat=False, impl="auto"):
    return mamba2.forward(cfg, params, batch["tokens"], remat=remat,
                          impl=impl)


def _mamba_prefill(cfg, params, batch, *, max_len=None, impl="auto"):
    return mamba2.prefill(cfg, params, batch["tokens"], max_len=max_len,
                          impl=impl)


def _hybrid_forward(cfg, params, batch, *, remat=False, impl="auto"):
    return hybrid.forward(cfg, params, batch["tokens"], remat=remat,
                          impl=impl)


def _hybrid_prefill(cfg, params, batch, *, max_len=None, impl="auto"):
    return hybrid.prefill(cfg, params, batch["tokens"], max_len=max_len,
                          impl=impl)


def _encdec_forward(cfg, params, batch, *, remat=False, impl="auto"):
    return encdec.forward(cfg, params, batch["tokens"],
                          frames=batch["frames"], remat=remat, impl=impl)


def _encdec_prefill(cfg, params, batch, *, max_len=None, impl="auto"):
    return encdec.prefill(cfg, params, batch["tokens"],
                          frames=batch["frames"], max_len=max_len, impl=impl)


_TRANSFORMER = ModelApi(transformer.init, _tf_forward, _tf_prefill,
                        transformer.decode_step, transformer.init_cache)

_FAMILY_API: Dict[str, ModelApi] = {
    "dense": _TRANSFORMER,
    "moe": _TRANSFORMER,
    "vlm": _TRANSFORMER,
    "ssm": ModelApi(mamba2.init, _mamba_forward, _mamba_prefill,
                    mamba2.decode_step, mamba2.init_cache),
    "hybrid": ModelApi(hybrid.init, _hybrid_forward, _hybrid_prefill,
                       hybrid.decode_step, hybrid.init_cache),
    "encdec": ModelApi(encdec.init, _encdec_forward, _encdec_prefill,
                       encdec.decode_step, encdec.init_cache),
}


def get_api(cfg: ModelConfig) -> ModelApi:
    try:
        return _FAMILY_API[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family {cfg.family!r}") from None


def abstract_params(cfg: ModelConfig) -> Dict:
    """The family's params tree on the ``meta`` device: every leaf's
    shape and dtype, nothing drawn and nothing allocated (the JAX
    ``jax.eval_shape`` of ``init``; full-depth grok-1 is 633 GB in
    bf16)."""
    return get_api(cfg).init(cfg, None, device="meta")
