"""The step units on a mesh: the train, prefill and serve steps with
their inputs placed as DTensors by a cell's shardings.

The JAX package gets a sharded step from ``jax.jit`` with in-shardings
and a mesh context. The port places each argument tree on its
shardings (``cell_shardings.attach``) and runs the same step function
under :func:`on_mesh`: the active mesh of ``sharding.constrain``, the
logical rule set, and DTensor's implicit replication of the plain
tensors the models make (positions, masks, zeros). DTensor propagates
the shardings op by op and inserts the collectives; an op it cannot
shard raises, so a step never runs unsharded in silence.

The same functions place the dry run's abstract trees (meta DTensors,
no storage) and real ones (``distribute_tensor``: every rank passes the
same full tensor).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..distributed.optimizer import Optimizer, tree_map
from ..distributed.sharding import logical_mode, mesh_context
from ..models.config import ModelConfig
from . import cell_shardings as cs


@contextlib.contextmanager
def on_mesh(mesh, rules: str = "default") -> Iterator:
    """Run a step on ``mesh`` with the logical rule set ``rules``."""
    with mesh_context(mesh), logical_mode(rules), implicit_replication():
        yield


def sharded(step: Callable, mesh, rules: str = "default") -> Callable:
    """``step`` run :func:`on_mesh`."""
    def run(*args):
        with on_mesh(mesh, rules):
            return step(*args)
    return run


def rules_for(batch_mode: str, rules_mode: Optional[str]) -> str:
    """The activation rule set of a variant, as the JAX dry run picks
    it: ``rules_mode``, else dp-all's for a dp-all batch."""
    return rules_mode or ("dp-all" if batch_mode == "dp-all" else "default")


def place_train(cfg: ModelConfig, mesh, params: Dict, opt: Optimizer,
                batch: Dict, *, param_mode: Optional[str] = None,
                batch_mode: str = "default") -> Tuple[Dict, Dict, Dict, str]:
    """(params, ZeRO-1 optimizer state, batch, param policy) of a train
    cell on ``mesh``."""
    p_shard, policy = cs.params_shardings_for(cfg, mesh, params,
                                              mode=param_mode or "train")
    params = cs.attach(params, p_shard)
    state = opt.init(params, opt.state_shardings(params, mesh))
    batch = cs.attach(batch, cs.train_batch_shardings(mesh, batch,
                                                      mode=batch_mode))
    return params, state, batch, policy


def place_prefill(cfg: ModelConfig, mesh, params: Dict, batch: Dict, *,
                  param_mode: Optional[str] = None,
                  batch_mode: str = "default") -> Tuple[Dict, Dict, str]:
    """(params, batch, param policy) of a prefill cell on ``mesh``."""
    p_shard, policy = cs.params_shardings_for(cfg, mesh, params,
                                              mode=param_mode or "serve")
    return (cs.attach(params, p_shard),
            cs.attach(batch, cs.train_batch_shardings(mesh, batch,
                                                      mode=batch_mode)),
            policy)


def place_decode(cfg: ModelConfig, mesh, params: Dict, cache: Dict,
                 tokens: torch.Tensor, *, param_mode: Optional[str] = None
                 ) -> Tuple[Dict, Dict, torch.Tensor, str]:
    """(params, cache, tokens, param policy) of a decode cell on
    ``mesh``."""
    p_shard, policy = cs.params_shardings_for(cfg, mesh, params,
                                              mode=param_mode or "serve")
    return (cs.attach(params, p_shard),
            cs.attach(cache, cs.cache_shardings(cfg, mesh, cache)),
            cs.attach(tokens, cs.token_sharding(mesh, tokens.shape[0])),
            policy)


def full(tree):
    """``tree`` with every DTensor leaf gathered to a plain tensor."""
    if isinstance(tree, dict):
        return tree_map(full, tree)
    return tree.full_tensor() if isinstance(tree, DTensor) else tree

