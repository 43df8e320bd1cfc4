"""Bridge from the JAX package's parameter tree to the port's params.

The tests run both packages on the same weights: they build params with
the JAX ``init`` of a family, turn every leaf into a numpy array
(``np.asarray``) and hand the tree here. :func:`params_on_mesh` places
such a tree on a mesh as DTensors by a cell's shardings. This module
imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .models.config import ModelConfig


def tensor_from_numpy(a: np.ndarray, device: "str | torch.device" = "cuda",
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One numpy array as a torch tensor. bfloat16 arrives as
    ``ml_dtypes`` bfloat16, which ``torch.from_numpy`` rejects, so it
    goes through its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(cfg: ModelConfig, tree: Dict,
                      device: "str | torch.device" = "cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """The JAX parameter tree (nested dicts of numpy arrays, layers
    stacked on a leading ``L`` axis) as the port's params, same keys and
    layouts, at any depth (a hybrid tree's unstacked ``shared`` block
    too). Each leaf keeps its own dtype unless ``dtype`` is given: a
    mamba2 tree in bfloat16 keeps its float32 ``A_log``, ``D`` and
    ``dt_bias``, as the JAX init makes them. ``cfg`` is the config the
    tree was made for."""

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return tensor_from_numpy(node, device, dtype)

    return convert(tree)


def params_on_mesh(cfg: ModelConfig, params: Dict, mesh, *,
                   mode: str = "train") -> Tuple[Dict, str]:
    """(``params`` as DTensors on ``mesh``, the policy) by
    ``launch/cell_shardings.params_shardings_for(..., mode=mode)``:
    every rank passes the same full tree (from
    :func:`params_from_numpy`, on the mesh's device) and keeps its
    shards."""
    from .launch import cell_shardings as cs
    shardings, policy = cs.params_shardings_for(cfg, mesh, params, mode=mode)
    return cs.attach(params, shardings), policy
