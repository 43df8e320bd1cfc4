"""Dense decoder-only transformer: init and the paged serving path.

Port of the JAX package's ``models/transformer.py`` for the dense
family: :func:`init`, :func:`decode_step_paged` and
:func:`prefill_chunk_paged`. Per-layer params stay stacked on a leading
``L`` axis (the JAX layout, so the tests compare like with like); the
layer ``lax.scan`` becomes a Python loop over that axis.

The page pool ``{"k": [L, n_pages, page, Hk, hd], "v": ...}`` is updated
in place: the JAX functions return a new pool, these write into the one
they are given. Every write and every kernel read is on PyTorch's
current stream, so they run in program order.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels import ops
from . import layers as nn
from .config import ModelConfig


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port serves the dense family only; {cfg.family!r} is a "
            "later slice (ROADMAP.md, queue A)")


def init(cfg: ModelConfig, gen: torch.Generator,
         device: "str | torch.device" = "cuda") -> Dict:
    """Random params from ``gen`` (std ``fan_in**-0.5`` projections,
    0.02 embeddings, zero norm scales), in ``cfg.dtype`` on ``device``."""
    _check_family(cfg)
    device = nn.resolve_device(device)
    d = cfg.d_model

    def norm():
        return {"scale": torch.zeros((d,), dtype=nn.dt(cfg), device=device)}

    per_layer = [{"ln1": norm(),
                  "attn": nn.init_attention(gen, cfg, device),
                  "ln2": norm(),
                  "mlp": nn.init_mlp(gen, cfg, device)}
                 for _ in range(cfg.n_layers)]
    stacked = {group: {name: torch.stack([lp[group][name] for lp in per_layer])
                       for name in per_layer[0][group]}
               for group in per_layer[0]}
    params = {
        "embed": {"table": nn.embed_init(gen, (cfg.vocab, d), nn.dt(cfg),
                                         device)},
        "layers": stacked,
        "final_norm": norm(),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": nn.embed_init(gen, (cfg.vocab, d),
                                                    nn.dt(cfg), device)}
    return params


def layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the stacked ``params["layers"]`` (views)."""
    return {group: {name: w[i] for name, w in ws.items()}
            for group, ws in params["layers"].items()}


def _head(cfg: ModelConfig, params: Dict) -> Dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def decode_step_paged(cfg: ModelConfig, params: Dict, pool: Dict,
                      tokens: torch.Tensor,       # [B] current token
                      page_table: torch.Tensor,   # [B, pages_per_seq] int32
                      seq_lens: torch.Tensor,     # [B] tokens BEFORE this step
                      *,
                      max_pages: Optional[int] = None,
                      impl: str = "auto",
                      ) -> torch.Tensor:
    """One decode iteration against the paged KV pool. The whole decode
    set goes through one batched paged-attention call per layer: the new
    token's K/V rides along as a fused kernel operand and is scattered
    into the page owning slot ``seq_lens[b]`` after the call (in place).
    ``max_pages`` bounds the kernel's page loop to the deepest live
    sequence. Returns logits [B, V]."""
    _check_family(cfg)
    page_size = pool["k"].shape[2]
    seq_lens = seq_lens.long()
    x = nn.embed(cfg, params["embed"], tokens)          # [B, d]
    offset = seq_lens % page_size
    phys = page_table.long().gather(1, (seq_lens // page_size)[:, None])[:, 0]

    h = x
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        kp, vp = pool["k"][i], pool["v"][i]            # [n_pages, page, Hk, hd]
        attn_in = nn.rms_norm(h, lp["ln1"]["scale"])
        q, k_new, v_new = nn.qkv_project(lp["attn"], attn_in)
        if cfg.pos == "rope":
            q = nn.apply_rope(q, seq_lens, cfg.rope_theta)
            k_new = nn.apply_rope(k_new, seq_lens, cfg.rope_theta)
        attn = ops.batched_paged_decode_attention(
            q, kp, vp, page_table, seq_lens, k_new, v_new,
            max_pages=max_pages, logit_softcap=cfg.logit_softcap, impl=impl)
        # in-place pool update, after the kernel's read on the same stream
        kp[phys, offset] = k_new.to(kp.dtype)
        vp[phys, offset] = v_new.to(vp.dtype)
        h = h + nn.merge_heads(attn, lp["attn"]["wo"])
        h = h + nn.mlp_block(cfg, lp["mlp"], nn.rms_norm(h, lp["ln2"]["scale"]))
    h = nn.rms_norm(h, params["final_norm"]["scale"])
    return nn.unembed(cfg, _head(cfg, params), h)


def prefill_chunk_paged(cfg: ModelConfig, params: Dict, pool: Dict,
                        tokens: torch.Tensor,       # [B, C] chunk token ids
                        page_table: torch.Tensor,   # [B, pages_per_seq] int32
                        q_offset: torch.Tensor,     # [B] abs pos of col 0
                        *,
                        impl: str = "auto",
                        ) -> torch.Tensor:
    """One prefill chunk against the paged pool, via the fused
    chunked-prefill kernel. Per layer: project the slab's Q/K/V at
    absolute positions ``[q_offset, q_offset + C)``, scatter K/V into the
    pages owning those slots (in place), then attend the slab against
    *everything resident* — prefix-tree pages and the chunks scattered
    by earlier calls — with query-offset causal masking. Resuming from a
    cached prefix is just starting at ``q_offset > 0``. Returns the
    last-position logits [B, V]."""
    _check_family(cfg)
    B, C = tokens.shape
    page_size = pool["k"].shape[2]
    q_offset = q_offset.long()
    positions = q_offset[:, None] + torch.arange(C, device=tokens.device)
    phys = page_table.long().gather(1, positions // page_size)   # [B, C]
    offset = positions % page_size
    kv_lens = q_offset + C

    h = nn.embed(cfg, params["embed"], tokens)           # [B, C, d]
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        kp, vp = pool["k"][i], pool["v"][i]
        attn_in = nn.rms_norm(h, lp["ln1"]["scale"])
        q, k, v = nn.qkv_project(lp["attn"], attn_in)   # [B, C, H/Hk, hd]
        if cfg.pos == "rope":
            q = nn.apply_rope(q, positions, cfg.rope_theta)
            k = nn.apply_rope(k, positions, cfg.rope_theta)
        # in-place scatter of the slab's K/V before the kernel reads it
        kp[phys, offset] = k.to(kp.dtype)
        vp[phys, offset] = v.to(vp.dtype)
        attn = ops.chunked_prefill_attention(
            q, kp, vp, page_table, q_offset, kv_lens,
            logit_softcap=cfg.logit_softcap, impl=impl)
        h = h + nn.merge_heads(attn, lp["attn"]["wo"])
        h = h + nn.mlp_block(cfg, lp["mlp"], nn.rms_norm(h, lp["ln2"]["scale"]))
    h = nn.rms_norm(h[:, -1], params["final_norm"]["scale"])
    return nn.unembed(cfg, _head(cfg, params), h)
