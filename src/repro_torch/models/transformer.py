"""Decoder-only transformer of the dense, moe and vlm families: init,
the training forward and both serving paths.

Port of the JAX package's ``models/transformer.py``: :func:`init`; the
full-sequence :func:`forward` the trainer runs (one flash-attention
call per layer); the slot-ring path (:func:`cache_size`,
:func:`init_cache`, :func:`prefill`, :func:`decode_step`, with the
sliding-window ring and the int8 KV cache); and the paged path
(:func:`decode_step_paged`, :func:`prefill_chunk_paged`, and
:func:`prefill_kv`, the vlm's single-shot prefill into pages). Per-layer
params stay stacked on a leading ``L`` axis (the JAX layout, so the
tests compare like with like); the layer ``lax.scan`` becomes a Python
loop over that axis. An MoE layer's MLP is ``layers.moe_block`` (its
aux loss summed over layers by :func:`forward`; the decode paths route
one group of the whole batch, ``layers.moe_block_decode``). A vlm
(paligemma) puts the stub patch embeddings ``patches`` [B, prefix_len,
d] before the token embeddings and attends them with prefix-LM masking
(``cfg.prefix_len``).

The caches are updated in place: the contiguous cache
``{"k": [L, B, S, Hk, hd], "v": ..., "lens": [B]}`` (plus ``k_scale`` /
``v_scale`` for int8) by :func:`decode_step`, which returns the same
K/V tensors with new ``lens``; the page pool
``{"k": [L, n_pages, page, Hk, hd], "v": ...}`` by the paged functions.
The JAX functions return new caches instead. Every write and every
kernel read is on PyTorch's current stream, so they run in program
order.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..distributed import sharding as shd
from ..distributed.sharding import constrain
from ..kernels import ops
from . import layers as nn
from .config import ModelConfig


_FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"the transformer runs the {_FAMILIES} families, "
                         f"not {cfg.family!r}")


def init(cfg: ModelConfig, gen: torch.Generator,
         device: "str | torch.device" = "cuda") -> Dict:
    """Random params from ``gen`` (std ``fan_in**-0.5`` projections,
    0.02 embeddings, zero norm scales), in ``cfg.dtype`` on ``device``
    (an MoE router in float32), layer by layer into the stacked leaves
    (``layers.init_stacked``: one layer's float32 draw at a time)."""
    _check_family(cfg)
    device = nn.resolve_device(device)
    d = cfg.d_model

    def draw_layer():
        lp = {"ln1": nn.init_norm(cfg, device),
              "attn": nn.init_attention(gen, cfg, device),
              "ln2": nn.init_norm(cfg, device)}
        if cfg.family == "moe":
            lp["moe"] = nn.init_moe(gen, cfg, device)
        else:
            lp["mlp"] = nn.init_mlp(gen, cfg, device)
        return lp

    stacked = nn.init_stacked(cfg.n_layers, draw_layer)
    params = {
        "embed": {"table": nn.embed_init(gen, (cfg.vocab, d), nn.dt(cfg),
                                         device)},
        "layers": stacked,
        "final_norm": nn.init_norm(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": nn.embed_init(gen, (cfg.vocab, d),
                                                    nn.dt(cfg), device)}
    return params


def layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the stacked ``params["layers"]`` (views)."""
    return {group: {name: shd.layer(w, i) for name, w in ws.items()}
            for group, ws in params["layers"].items()}


def _head(cfg: ModelConfig, params: Dict) -> Dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def _mlp(cfg: ModelConfig, lp: Dict,
         x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's MLP, or its MoE block, on x [B, L, d]: (out, the
    layer's aux loss; 0 for dense and vlm)."""
    if cfg.family == "moe":
        return nn.moe_block(cfg, lp["moe"], x)
    return nn.mlp_block(cfg, lp["mlp"], x), torch.zeros((), device=x.device)


def _mlp_decode(cfg: ModelConfig, lp: Dict, x: torch.Tensor) -> torch.Tensor:
    """The layer's MLP or decode-path MoE block on x [B, d]."""
    if cfg.family == "moe":
        return nn.moe_block_decode(cfg, lp["moe"], x)
    return nn.mlp_block(cfg, lp["mlp"], x)


def _prefix(cfg: ModelConfig) -> int:
    return cfg.prefix_len if cfg.family == "vlm" else 0


def _embed_inputs(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  patches: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings [B, Lt, d], after the stub patch embeddings [B,
    prefix_len, d] (cast to the embedding dtype) for a vlm."""
    x = nn.embed(cfg, params["embed"], tokens)
    if cfg.family == "vlm":
        if patches is None:
            raise ValueError("a vlm needs its stub patch embeddings "
                             "(patches [B, prefix_len, d_model])")
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return x


def _layer_fwd(cfg: ModelConfig, lp: Dict, carry, *, prefix_len: int,
               impl: str):
    """One decoder layer over the full sequence: carry (h [B, L, d],
    the aux loss so far) -> (h, aux plus this layer's)."""
    h, aux = carry
    h = constrain(h, "batch", None, "residual")
    h = h + nn.attention_block(cfg, lp["attn"],
                               nn.apply_norm(cfg, lp["ln1"], h),
                               window=cfg.sliding_window,
                               prefix_len=prefix_len, impl=impl)
    out, layer_aux = _mlp(cfg, lp, nn.apply_norm(cfg, lp["ln2"], h))
    return constrain(h + out, "batch", None, "residual"), aux + layer_aux


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None,
            remat: bool = False, impl: str = "auto",
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits [B, L, V], the layers' summed MoE
    aux loss; 0 for dense and vlm). A vlm's ``patches`` come first, so
    its logits cover prefix_len + L positions. Attention is one
    flash-attention call per layer (causal, ``cfg.sliding_window``,
    prefix-LM over the patches), differentiable through
    ``ops.attention``. With ``remat`` the kernel runs twice per layer
    and step (see ``layers.run_layers``)."""
    _check_family(cfg)
    x = constrain(_embed_inputs(cfg, params, tokens, patches),
                  "batch", None, "residual")
    body = functools.partial(_layer_fwd, cfg, prefix_len=_prefix(cfg),
                             impl=impl)
    x, aux = nn.run_layers(body, (x, torch.zeros((), device=x.device)),
                           params["layers"], remat=remat)
    x = nn.apply_norm(cfg, params["final_norm"], x)
    logits = nn.unembed(cfg, _head(cfg, params), x)
    return logits, aux


# ---------------------------------------------------------------------------
# slot-ring (contiguous KV cache) serving path
# ---------------------------------------------------------------------------

def cache_size(cfg: ModelConfig, max_len: int) -> int:
    """Sliding-window archs keep a ring buffer of the window only."""
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: "str | torch.device" = "cuda") -> Dict:
    """Zeroed contiguous cache for ``batch`` slots of ``cache_size``
    positions in ``cfg.dtype``; int8 values with float32
    per-(position, head) scales when ``cfg.kv_dtype == "int8"``."""
    device = nn.resolve_device(device)
    S = cache_size(cfg, max_len)
    dtype = torch.int8 if cfg.kv_dtype == "int8" else nn.dt(cfg)
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.d_head)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "lens": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        cache["k_scale"] = torch.zeros(shape[:-1], device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], device=device)
    return cache


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None,
            impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Process the full prompt ``tokens`` [B, Lt] (after a vlm's
    ``patches``: L = prefix_len + Lt positions, else L = Lt); return
    (last-position logits [B, V], a filled cache of ``cache_size(cfg,
    max_len or L)`` positions). Attention is one flash-attention call
    per layer (causal, ``cfg.sliding_window``, prefix-LM over the
    patches). The cache keeps the trailing ``S`` positions; when a
    windowed prompt is longer than the ring it is rolled by ``L % S`` so
    that slot ``i`` holds position ``L - S + i`` modulo ``S``, as
    decode's ``pos % S`` indexing expects. (A vlm prompt longer than
    ``S`` keeps only its tail: :func:`prefill_kv` relies on that.)"""
    _check_family(cfg)
    h = _embed_inputs(cfg, params, tokens, patches)      # [B, L, d]
    B, L = h.shape[:2]
    S = cache_size(cfg, max_len or L)
    positions = torch.arange(L, device=tokens.device)[None].expand(B, L)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = constrain(h, "batch", None, "residual")
        attn_in = nn.apply_norm(cfg, lp["ln1"], h)
        q, k, v = nn.qkv_project(lp["attn"], attn_in)   # [B, L, H/Hk, hd]
        if cfg.pos == "rope":
            q = nn.apply_rope(q, positions, cfg.rope_theta)
            k = nn.apply_rope(k, positions, cfg.rope_theta)
        attn = ops.attention(q, k, v, causal=True, window=cfg.sliding_window,
                             logit_softcap=cfg.logit_softcap, impl=impl,
                             prefix_len=_prefix(cfg))
        h = h + nn.merge_heads(attn, lp["attn"]["wo"])
        h = h + _mlp(cfg, lp, nn.apply_norm(cfg, lp["ln2"], h))[0]
        k_keep = k[:, -S:].to(nn.dt(cfg))
        v_keep = v[:, -S:].to(nn.dt(cfg))
        if cfg.sliding_window is not None and L > S:
            shift = L % S
            k_keep = shd.roll(k_keep, shift, 1)
            v_keep = shd.roll(v_keep, shift, 1)
        ks.append(k_keep)
        vs.append(v_keep)
    h = nn.apply_norm(cfg, params["final_norm"], h[:, -1])
    logits = nn.unembed(cfg, _head(cfg, params), h)

    ks, vs = torch.stack(ks), torch.stack(vs)            # [L, B, <=S, Hk, hd]
    if L < S:
        pad = (0, 0, 0, 0, 0, S - L)
        ks = shd.pad(ks, pad)
        vs = shd.pad(vs, pad)
    cache = {"lens": torch.full((B,), min(L, S), dtype=torch.int32,
                                device=tokens.device)}
    if cfg.kv_dtype == "int8":
        cache["k"], cache["k_scale"] = nn.quantize_kv(ks)
        cache["v"], cache["v_scale"] = nn.quantize_kv(vs)
    else:
        cache["k"], cache["v"] = ks, vs
    return logits, cache


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor,          # [B] current token
                pos: "int | torch.Tensor",     # [] or [B] absolute position
                *, impl: str = "auto",
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode iteration for the whole batch against the contiguous
    cache: each slot writes its token's K/V at ring slot ``pos % S`` (in
    place) and attends its ``min(lens + 1, S)`` valid entries (the slot
    decode kernel, or by ``impl`` the plain version). Returns (logits
    [B, V], the cache with the same K/V tensors and new ``lens``)."""
    _check_family(cfg)
    S = cache["k"].shape[2]
    new_lens = torch.clamp(cache["lens"] + 1, max=S).to(torch.int32)
    quant = "k_scale" in cache
    h = nn.embed(cfg, params["embed"], tokens)           # [B, d]
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        scales = ((cache["k_scale"][i], cache["v_scale"][i]) if quant
                  else None)
        h = constrain(h, "batch", "model")
        attn_in = nn.apply_norm(cfg, lp["ln1"], h)
        h = h + nn.attention_decode(
            cfg, lp["attn"], attn_in, cache["k"][i], cache["v"][i], pos,
            new_lens, kv_scales=scales, impl=impl)
        h = h + _mlp_decode(cfg, lp, nn.apply_norm(cfg, lp["ln2"], h))
    h = nn.apply_norm(cfg, params["final_norm"], h)
    return nn.unembed(cfg, _head(cfg, params), h), {**cache, "lens": new_lens}


# ---------------------------------------------------------------------------
# paged serving path
# ---------------------------------------------------------------------------

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
    # the kernel's int32 operands, made once per step for every layer
    table32 = page_table.to(torch.int32).contiguous()
    lens32 = seq_lens.to(torch.int32).contiguous()
    seq_lens = seq_lens.long()
    x = nn.embed(cfg, params["embed"], tokens)          # [B, d]
    offset = seq_lens % page_size
    phys = page_table.long().gather(1, (seq_lens // page_size)[:, None])[:, 0]

    h = x
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        kp, vp = pool["k"][i], pool["v"][i]            # [n_pages, page, Hk, hd]
        h = constrain(h, "batch", "model")
        attn_in = nn.apply_norm(cfg, lp["ln1"], h)
        q, k_new, v_new = nn.qkv_project(lp["attn"], attn_in)
        if cfg.pos == "rope":
            q = nn.apply_rope(q, seq_lens, cfg.rope_theta)
            k_new = nn.apply_rope(k_new, seq_lens, cfg.rope_theta)
        attn = ops.batched_paged_decode_attention(
            q, kp, vp, table32, lens32, k_new, v_new,
            max_pages=max_pages, logit_softcap=cfg.logit_softcap, impl=impl)
        # in-place pool update, after the kernel's read on the same stream
        kp[phys, offset] = k_new.to(kp.dtype)
        vp[phys, offset] = v_new.to(vp.dtype)
        h = h + nn.merge_heads(attn, lp["attn"]["wo"])
        h = h + _mlp_decode(cfg, lp, nn.apply_norm(cfg, lp["ln2"], h))
    h = nn.apply_norm(cfg, params["final_norm"], h)
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
        h = constrain(h, "batch", None, "residual")
        attn_in = nn.apply_norm(cfg, lp["ln1"], h)
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
        h = h + _mlp(cfg, lp, nn.apply_norm(cfg, lp["ln2"], h))[0]
    h = nn.apply_norm(cfg, params["final_norm"], h[:, -1])
    return nn.unembed(cfg, _head(cfg, params), h)


def prefill_kv(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
               patches: Optional[torch.Tensor] = None,
               impl: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill returning the raw per-layer K/V [L, B, S, Hk, hd] (for
    scattering into the paged pool) and the last-position logits, as
    JAX's: :func:`prefill` at ``max_len`` = the token count, so ``S`` =
    Lt. With a vlm's patches that keeps only the text tokens' K/V (rope
    positions prefix_len ..), not the prefix's (ROADMAP.md, C9)."""
    logits, cache = prefill(cfg, params, tokens, patches=patches,
                            max_len=tokens.shape[1], impl=impl)
    return logits, cache["k"], cache["v"]
