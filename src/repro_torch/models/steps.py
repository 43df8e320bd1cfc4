"""Train, prefill and serve step functions of the port.

Port of the JAX package's ``models/steps.py``:

* ``cross_entropy``, ``loss_fn`` and ``make_train_step`` -- the
  trainer's unit: loss, gradients and one optimizer update, with
  per-layer remat;
* ``sample_logits`` -- the serving engine's sampler;
* ``make_prefill_step`` / ``make_serve_step`` -- the serving iteration
  units: prefill the prompt / advance every active decode slot one
  token (greedy or temperature sampling). With the train step they are
  the units the dry run (``launch/dryrun.py``) counts on the ``meta``
  device and ``chip_smoke.py`` runs on the card.

All steps take ``batch`` dicts (tokens, labels, and the vlm ``patches``
/ encdec ``frames``), so one dry run covers every family. A
``torch.Generator`` takes the place of the JAX key.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..distributed.optimizer import tree_leaves, tree_map
from ..distributed.sharding import constrain, take_last, whole_dim
from .config import ModelConfig
from .registry import get_api

# profiler range around the optimizer update of a train step
OPTIMIZER_UPDATE = "optimizer.update"


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in float32. logits [B, L, V] (any
    dtype), labels [B, L] ints; ``mask`` weights the positions."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)                          # [B, L]
    true_logit = take_last(lf, labels.long())
    nll = lse - true_logit
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict, *,
            remat: bool = True, impl: str = "auto"
            ) -> Tuple[torch.Tensor, Dict]:
    """(total loss, {"loss", "ce", "aux"}) of one batch (``tokens``,
    ``labels`` and optional ``loss_mask`` tensors)."""
    logits, aux = get_api(cfg).forward(cfg, params, batch, remat=remat,
                                       impl=impl)
    labels = batch["labels"]
    L = labels.shape[1]
    if logits.shape[1] != L:       # a prefix before the tokens: score the tail
        logits = logits[:, -L:]
    logits = constrain(logits, "batch", None, "model")
    ce = cross_entropy(logits, labels, batch.get("loss_mask"))
    total = ce + cfg.router_aux_coef * aux
    return total, {"loss": total, "ce": ce, "aux": aux}


def grads_of(loss: torch.Tensor, params: Dict) -> Dict:
    """d loss / d params as a tree like ``params`` (zeros for a leaf the
    loss does not reach, as ``jax.grad`` gives)."""
    grads = iter(torch.autograd.grad(loss, tree_leaves(params),
                                     allow_unused=True, materialize_grads=True))
    return tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, optimizer, *, remat: bool = True,
                    impl: str = "auto") -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``. ``optimizer`` is a
    ``repro_torch.distributed.optimizer.Optimizer``; it updates the
    params and its state in place and the step returns the same trees.
    Every param leaf is set to require grad. Metrics are 0-dim tensors
    on the params' device (``loss``, ``ce``, ``aux``, ``grad_norm``,
    ``lr``, ``step``)."""

    def train_step(params, opt_state, batch):
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, metrics = loss_fn(cfg, params, batch, remat=remat, impl=impl)
        grads = grads_of(loss, params)
        with torch.profiler.record_function(OPTIMIZER_UPDATE):
            params, opt_state, opt_metrics = optimizer.update(
                params, grads, opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def sample_logits(logits: torch.Tensor, gen: Optional[torch.Generator],
                  temperature: float = 0.0) -> torch.Tensor:
    """Greedy (temperature=0) or temperature sampling. logits [B, V].

    Greedy takes the first index among tied maxima, as ``jnp.argmax``
    does. Temperature sampling draws from ``gen`` (which must live on
    the logits' device); it cannot reproduce ``jax.random``'s bits."""
    # the vocab whole on every rank of a mesh: DTensor's sharded argmax
    # fails on a pod x data x model mesh
    logits = whole_dim(logits, -1)
    if temperature <= 0.0 or gen is None:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def make_prefill_step(cfg: ModelConfig, *, max_len: int, impl: str = "auto",
                      temperature: float = 0.0) -> Callable:
    """``prefill_step(params, batch, gen) -> (first_tokens, cache)``:
    the family's prefill of ``batch`` into a cache of ``max_len``
    positions, then one token per sequence sampled from the last
    logits (``gen`` as in :func:`sample_logits`)."""
    api = get_api(cfg)

    def prefill_step(params, batch, gen):
        logits, cache = api.prefill(cfg, params, batch, max_len=max_len,
                                    impl=impl)
        return sample_logits(logits, gen, temperature), cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, impl: str = "auto",
                    temperature: float = 0.0) -> Callable:
    """``serve_step(params, cache, tokens, pos, gen) -> (next_tokens,
    cache)``: one new token per active sequence against the KV / SSM
    cache, the unit of the ``decode_32k`` and ``long_500k`` cells.
    ``impl`` goes to the decode step's attention
    (``ops.decode_attention``): a cache that ``cell_shardings`` splits on
    S (kv heads that do not divide the model axis) has no kernel, so on
    CUDA tensors its serve step takes ``impl='reference'``."""
    api = get_api(cfg)

    def serve_step(params, cache, tokens, pos, gen):
        logits, cache = api.decode_step(cfg, params, cache, tokens, pos,
                                        impl=impl)
        return sample_logits(logits, gen, temperature), cache

    return serve_step
