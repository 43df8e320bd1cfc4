"""Serving step helpers of the port: token sampling.

Port of ``sample_logits`` from the JAX package's ``models/steps.py``
(the training and dry-run step functions move with later slices).
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_logits(logits: torch.Tensor, gen: Optional[torch.Generator],
                  temperature: float = 0.0) -> torch.Tensor:
    """Greedy (temperature=0) or temperature sampling. logits [B, V].

    Greedy takes the first index among tied maxima, as ``jnp.argmax``
    does. Temperature sampling draws from ``gen`` (which must live on
    the logits' device); it cannot reproduce ``jax.random``'s bits."""
    if temperature <= 0.0 or gen is None:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]
