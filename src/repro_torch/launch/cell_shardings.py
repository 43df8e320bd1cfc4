"""Per-cell sharding assignment: the sharding trees of every (arch x
shape x mesh) dry-run cell, and their placement as DTensors.

Port of the JAX package's ``launch/cell_shardings.py``, same functions
and decisions, over the port's trees (nested dicts of tensors, the same
keys and cache leaf names):

* params -- ``param_shardings`` rules (TP on heads / d_ff / experts /
  vocab); training and big-arch serving additionally spread each
  param's largest free dim over the data axis (FSDP / weight-gathered
  serving) so nothing replicated outgrows HBM;
* batch inputs -- batch dim over (pod, data) when divisible;
* KV caches -- batch on (pod, data); kv-heads on model when divisible,
  else the *sequence* dim on model, else replicated;
* SSM states -- batch on data, ssm-heads on model;
* scalars / lens -- replicated (lens batch-sharded).

:func:`attach` puts a tree on its shardings: meta DTensors for the
abstract trees of the dry run, ``distribute_tensor`` for real ones.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import distribute_tensor

from ..distributed.sharding import (NamedSharding, P, axis_sizes,
                                    empty_dtensor, param_shardings, spec_axes,
                                    tree_map_with_path, tree_paths)
from ..models.config import ModelConfig

# replicated-param bytes above this threshold switch serving to
# weight-gathered (params also sharded over data) mode
SERVE_GATHER_THRESHOLD = 4 * 2**30  # 4 GiB / device


def batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """Largest (pod, data) prefix that divides the batch."""
    sizes = axis_sizes(mesh)
    chosen, total = [], 1
    for ax in ("pod", "data"):
        if ax in sizes and batch % (total * sizes[ax]) == 0:
            chosen.append(ax)
            total *= sizes[ax]
    return tuple(chosen)


def batch_part(mesh, batch: int):
    axes = batch_axes(mesh, batch)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def token_sharding(mesh, batch: int) -> NamedSharding:
    return NamedSharding(mesh, P(batch_part(mesh, batch)))


def all_axes_batch_part(mesh, batch: int):
    """Batch over EVERY mesh axis (pure-DP layout for small models)."""
    sizes = axis_sizes(mesh)
    chosen, total = [], 1
    for ax in ("pod", "data", "model"):
        if ax in sizes and batch % (total * sizes[ax]) == 0:
            chosen.append(ax)
            total *= sizes[ax]
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def train_batch_shardings(mesh, batch_specs: Dict, *,
                          mode: str = "default") -> Dict:
    """tokens/labels [B, L] (+ modality stubs [B, T, d]).

    mode 'dp-all' spreads the batch over the model axis too -- the
    pure-data-parallel layout for models too small to tensor-shard."""
    part_fn = all_axes_batch_part if mode == "dp-all" else batch_part
    out = {}
    for name, t in batch_specs.items():
        b = t.shape[0]
        spec = [part_fn(mesh, b)] + [None] * (len(t.shape) - 1)
        out[name] = NamedSharding(mesh, P(*spec))
    return out


def _kv_spec(mesh, shape) -> P:
    """[L, B, S, Hk, hd] (self/cross KV cache)."""
    model = axis_sizes(mesh).get("model", 1)
    _, B, S, Hk, _ = shape
    bp = batch_part(mesh, B)
    if Hk % model == 0:
        return P(None, bp, None, "model", None)
    if S % model == 0:
        return P(None, bp, "model", None, None)
    return P(None, bp, None, None, None)


def cache_shardings(cfg: ModelConfig, mesh, cache_tree) -> Dict:
    """Shardings of a decode-cache tree (by leaf name)."""
    model = axis_sizes(mesh).get("model", 1)

    def leaf_spec(path, t):
        name = path.rsplit("/", 1)[-1]
        shp = tuple(t.shape)
        if name in ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v"):
            return _kv_spec(mesh, shp)
        if name in ("k_scale", "v_scale"):    # [L, B, S, Hk] int8 scales
            full = _kv_spec(mesh, shp + (0,))
            return P(*tuple(full)[:4])
        if name == "conv":            # [L, B, k-1, C]
            bp = batch_part(mesh, shp[1])
            cp = "model" if shp[3] % model == 0 else None
            return P(None, bp, None, cp)
        if name == "ssm":             # [L, B, H, P, N]
            bp = batch_part(mesh, shp[1])
            hp = "model" if shp[2] % model == 0 else None
            return P(None, bp, hp, None, None)
        if name == "lens":            # [B]
            return P(batch_part(mesh, shp[0]))
        return P(*([None] * len(shp)))

    return tree_map_with_path(
        lambda path, t: NamedSharding(mesh, leaf_spec(path, t)), cache_tree)


def _params_2d(cfg: ModelConfig, mesh, abstract_params) -> Dict:
    """Weight-stationary 2D sharding for serving big models: every large
    matrix is sharded over BOTH mesh axes (d_model rows on data, heads /
    d_ff columns on model), so no per-step weight all-gather is needed --
    contractions over sharded dims become small ACTIVATION all-reduces
    instead."""
    sizes = axis_sizes(mesh)
    d_ax = sizes.get("data", 1)
    m_ax = sizes.get("model", 1)

    def ok(dim, ax_size):
        return ax_size > 1 and dim % ax_size == 0

    def spec_for(path: str, shape) -> P:
        def two_d(rows_i, cols_i, rank):
            spec = [None] * rank
            if ok(shape[rows_i], d_ax):
                spec[rows_i] = "data"
            if ok(shape[cols_i], m_ax):
                spec[cols_i] = "model"
            return P(*spec)

        if path.endswith(("embed/table", "lm_head/table")):
            return two_d(1, 0, 2)            # [V@model, d@data]
        if path.endswith("attn/wq"):
            # [d, H, hd]: d on data; heads on model else head_dim
            spec = [None, None, None]
            if ok(shape[0], d_ax):
                spec[0] = "data"
            if ok(shape[-2], m_ax):
                spec[-2] = "model"
            elif ok(shape[-1], m_ax):
                spec[-1] = "model"
            return P(*spec)
        if path.endswith(("attn/wk", "attn/wv")):
            spec = [None] * len(shape)
            if ok(shape[-3], d_ax):
                spec[-3] = "data"
            if ok(shape[-2], m_ax):
                spec[-2] = "model"
            elif ok(shape[-1], m_ax):
                spec[-1] = "model"
            return P(*spec)
        if path.endswith("attn/wo"):
            spec = [None] * len(shape)
            if ok(shape[-3], m_ax):
                spec[-3] = "model"
            if ok(shape[-1], d_ax):
                spec[-1] = "data"
            return P(*spec)
        if path.endswith(("mlp/w1", "mlp/w3", "ssm/in_proj", "moe/w1",
                          "moe/w3")):
            spec = [None] * len(shape)
            if ok(shape[-2], d_ax):
                spec[-2] = "data"
            if ok(shape[-1], m_ax):
                spec[-1] = "model"
            return P(*spec)
        if path.endswith(("mlp/w2", "ssm/out_proj", "moe/w2")):
            spec = [None] * len(shape)
            if ok(shape[-2], m_ax):
                spec[-2] = "model"
            if ok(shape[-1], d_ax):
                spec[-1] = "data"
            return P(*spec)
        return P(*([None] * len(shape)))

    return tree_map_with_path(
        lambda path, t: NamedSharding(mesh, spec_for(path, tuple(t.shape))),
        abstract_params)


def local_bytes(tree, shardings) -> int:
    """Bytes per device of ``tree``'s leaves under ``shardings``."""
    sizes = axis_sizes(next(sh for _, sh in tree_paths(shardings)).mesh)
    total = 0
    for (_, t), (_, sh) in zip(tree_paths(tree), tree_paths(shardings)):
        denom = 1
        for part in sh.spec:
            for ax in spec_axes(part):
                denom *= sizes.get(ax, 1)
        total += t.numel() * t.element_size() // max(denom, 1)
    return total


def params_shardings_for(cfg: ModelConfig, mesh, abstract_params, *,
                         mode: str) -> Tuple[Dict, str]:
    """(sharding tree, policy description).
    mode: 'train' | 'serve' | 'replicated' | 'serve-2d'."""
    if mode == "replicated":
        return replicated(mesh, abstract_params), \
            "replicated (pure data parallelism)"
    if mode == "serve-2d":
        return _params_2d(cfg, mesh, abstract_params), \
            "weight-stationary 2D (d on data, heads/ff on model)"
    if mode == "train":
        shard, _ = param_shardings(abstract_params, mesh, zero_axis="data")
        return shard, "fsdp (model-TP + data-sharded params, ZeRO)"
    # serve: replicate over data unless the replicated size would blow HBM
    tp_only, _ = param_shardings(abstract_params, mesh)
    if local_bytes(abstract_params, tp_only) <= SERVE_GATHER_THRESHOLD:
        return tp_only, "tp-only (params replicated over data)"
    gathered, _ = param_shardings(abstract_params, mesh, zero_axis="data")
    return gathered, "weight-gathered (params sharded over data+model)"


def replicated(mesh, tree):
    return tree_map_with_path(
        lambda _, t: NamedSharding(mesh, P(*([None] * t.ndim))), tree)


def _place(t, sh: NamedSharding):
    if not isinstance(t, torch.Tensor):
        return t
    if t.device.type == "meta":
        return empty_dtensor(t.shape, sh.mesh, sh.placements(),
                             dtype=t.dtype, device="meta")
    return distribute_tensor(t, sh.mesh, sh.placements())


def attach(tree, shardings):
    """``tree`` with each tensor leaf on its sharding: a meta DTensor of
    the leaf's global shape for a meta leaf (no storage, any mesh size),
    ``distribute_tensor`` of it otherwise (every rank passes the same
    full tensor and keeps its shard)."""
    if isinstance(tree, dict):
        return {k: attach(tree[k], shardings[k]) for k in tree}
    return _place(tree, shardings)
