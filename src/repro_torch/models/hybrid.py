"""Zamba2-style hybrid (zamba2-1.2b): a Mamba-2 backbone and one
*shared* attention block.

Port of the JAX package's ``models/hybrid.py``. The shared block (one
parameter set) is applied before every ``cfg.attn_every``-th Mamba
layer, at layers ``0, attn_every, ...``. Its input is ``concat(h,
emb0)``, the hidden state beside the original token embedding, so it
runs at width ``2 * d_model`` (zamba2-1.2b: 4096 = 32 heads of 128);
its output is projected back to ``d_model`` and added to the residual.
Attention is causal within ``cfg.sliding_window``.

Serving keeps per-layer Mamba states (``mamba2.init_cache``'s ``conv``
and ``ssm``) and, for each application of the shared block, a ring of
``min(max_len, window)`` K/V entries (``attn_k`` / ``attn_v``
``[n_apps, B, S, Hk, D]``). ``prefill`` runs the shared block through
``ops.attention`` (the flash kernel on CUDA tensors, once per
application) and the Mamba layers through ``mamba2.prefill_layers``;
``decode_step`` runs ``layers.attention_decode`` (the slot decode
kernel on CUDA tensors) against the ring at ``pos % S`` and ``mamba2.decode_layers``, writing every state in
place (the JAX function returns a new cache). ``lens`` counts every
token; the attention sees ``min(lens + 1, S)`` entries.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from ..distributed import sharding as shd
from ..distributed.sharding import constrain
from ..kernels import ops
from . import layers as nn
from . import mamba2
from .config import ModelConfig


def _app_positions(cfg: ModelConfig) -> List[int]:
    return list(range(0, cfg.n_layers, cfg.attn_every))


def _segments(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """[(start, end)) Mamba-layer slices, one per shared-block
    application."""
    bounds = _app_positions(cfg) + [cfg.n_layers]
    return list(zip(bounds[:-1], bounds[1:]))


def init(cfg: ModelConfig, gen: torch.Generator,
         device: "str | torch.device" = "cuda") -> Dict:
    """Random params from ``gen``: ``mamba2.init``'s tree plus the
    shared block at width ``2 * d_model`` (the JAX init's distributions;
    its draws differ)."""
    device = nn.resolve_device(device)
    w = 2 * cfg.d_model
    params = mamba2.init(cfg, gen, device)
    params["shared"] = {
        "ln1": nn.init_norm(cfg, device, width=w),
        "attn": nn.init_attention(gen, cfg, device, width=w),
        "ln2": nn.init_norm(cfg, device, width=w),
        "mlp": nn.init_mlp(gen, cfg, device, width=w),
        "down": nn.dense_init(gen, (w, cfg.d_model), dtype=nn.dt(cfg),
                              device=device),
    }
    return params


def _head(cfg: ModelConfig, params: Dict) -> Dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _shared_out(cfg: ModelConfig, sp: Dict, u: torch.Tensor,
                attn: torch.Tensor) -> torch.Tensor:
    """The shared block after its attention: residual, MLP, down
    projection. u = concat(h, emb0), attn the attention's output."""
    v = u + attn
    v = v + nn.mlp_block(cfg, sp["mlp"], nn.apply_norm(cfg, sp["ln2"], v))
    return v @ sp["down"]


def _shared_apply(cfg: ModelConfig, sp: Dict, h: torch.Tensor,
                  emb0: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """One full-sequence application of the shared block."""
    u = torch.cat([h, emb0], dim=-1)
    attn = nn.attention_block(cfg, sp["attn"], nn.apply_norm(cfg, sp["ln1"], u),
                              window=cfg.sliding_window, impl=impl)
    return h + constrain(_shared_out(cfg, sp, u, attn), "batch", None, None)


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            remat: bool = False, impl: str = "auto",
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits [B, L, V], aux 0.0). With
    ``remat`` each Mamba layer is recomputed in the backward (the
    shared block is not, as in JAX)."""
    emb0 = nn.embed(cfg, params["embed"], tokens)
    h = constrain(emb0, "batch", None, None)
    layers = nn.unstack_layers(params["layers"])
    body = functools.partial(mamba2.layer_fwd, cfg, impl=impl)
    for s, e in _segments(cfg):
        h = _shared_apply(cfg, params["shared"], h, emb0, impl=impl)
        h = nn.run_layers(body, h, layers[s:e], remat=remat)
    h = nn.apply_norm(cfg, params["final_norm"], h)
    return nn.unembed(cfg, _head(cfg, params), h), \
        torch.zeros((), device=h.device)


# ---------------------------------------------------------------------------
# serving paths
# ---------------------------------------------------------------------------

def _attn_cache_size(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: "str | torch.device" = "cuda") -> Dict:
    """Zeroed serving state for ``batch`` slots: the Mamba layers'
    ``conv`` and ``ssm`` (as ``mamba2.init_cache``), the shared block's
    K/V rings ``[n_apps, B, S, Hk, D]`` in ``cfg.dtype``, ``lens [B]``."""
    state = mamba2.init_cache(cfg, batch, max_len, device)
    shape = (len(_app_positions(cfg)), batch, _attn_cache_size(cfg, max_len),
             cfg.n_kv_heads, cfg.d_head)
    kw = dict(dtype=nn.dt(cfg), device=state["lens"].device)
    return {"conv": state["conv"], "ssm": state["ssm"],
            "attn_k": torch.zeros(shape, **kw),
            "attn_v": torch.zeros(shape, **kw), "lens": state["lens"]}


def _ring(t: torch.Tensor, L: int, S: int, cfg: ModelConfig) -> torch.Tensor:
    """The trailing ``S`` positions of ``t`` [B, L, Hk, D] as a ring in
    ``cfg.dtype``: rolled by ``L % S`` when a windowed prompt overflows
    it (so slot ``i`` holds a position congruent to ``i`` modulo ``S``,
    as decode's ``pos % S`` writes expect), zero-padded to ``S`` when
    the prompt is shorter."""
    keep = t[:, -S:].to(nn.dt(cfg))
    if cfg.sliding_window is not None and L > S:
        keep = shd.roll(keep, L % S, 1)
    if L < S:
        keep = shd.pad(keep, (0, 0, 0, 0, 0, S - L))
    return keep


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, impl: str = "auto",
            ) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt ``tokens`` [B, L]: (last-position logits
    [B, V], a filled cache with rings of ``min(max_len or L, window)``
    positions). Each application of the shared block is one
    flash-attention call (causal, the window)."""
    B, L = tokens.shape
    S = _attn_cache_size(cfg, max_len or L)
    emb0 = nn.embed(cfg, params["embed"], tokens)
    h = emb0
    sp = params["shared"]
    layers = nn.unstack_layers(params["layers"])
    positions = torch.arange(L, device=tokens.device)[None].expand(B, L)
    ks, vs, conv, ssm = [], [], [], []
    for s, e in _segments(cfg):
        u = torch.cat([h, emb0], dim=-1)
        q, k, v = nn.qkv_project(sp["attn"], nn.apply_norm(cfg, sp["ln1"], u))
        if cfg.pos == "rope":
            q = nn.apply_rope(q, positions, cfg.rope_theta)
            k = nn.apply_rope(k, positions, cfg.rope_theta)
        attn = ops.attention(q, k, v, causal=True, window=cfg.sliding_window,
                             logit_softcap=cfg.logit_softcap, impl=impl)
        h = h + _shared_out(cfg, sp, u, nn.merge_heads(attn, sp["attn"]["wo"]))
        ks.append(_ring(k, L, S, cfg))
        vs.append(_ring(v, L, S, cfg))
        h = mamba2.prefill_layers(cfg, layers[s:e], h, conv, ssm)
    h = nn.apply_norm(cfg, params["final_norm"], h[:, -1])
    return nn.unembed(cfg, _head(cfg, params), h), {
        "conv": torch.stack(conv), "ssm": torch.stack(ssm),
        "attn_k": torch.stack(ks), "attn_v": torch.stack(vs),
        "lens": torch.full((B,), L, dtype=torch.int32, device=tokens.device)}


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor,          # [B] current token
                pos: "int | torch.Tensor",     # [] or [B] absolute position
                *, impl: str = "auto",
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode iteration for every slot: each application of the
    shared block writes its token's K/V at ring slot ``pos % S`` and
    attends ``min(lens + 1, S)`` entries (``ops.decode_attention`` by
    ``impl``); the Mamba layers
    step their states. Every state is written in place. Returns (logits
    [B, V], the cache with ``lens + 1``)."""
    emb0 = nn.embed(cfg, params["embed"], tokens)        # [B, d]
    h = emb0
    sp = params["shared"]
    S = cache["attn_k"].shape[2]
    attn_lens = torch.clamp(cache["lens"] + 1, max=S).to(torch.int32)
    layers = nn.unstack_layers(params["layers"])
    for i, (s, e) in enumerate(_segments(cfg)):
        u = torch.cat([h, emb0], dim=-1)
        attn = nn.attention_decode(cfg, sp["attn"],
                                   nn.apply_norm(cfg, sp["ln1"], u),
                                   cache["attn_k"][i], cache["attn_v"][i],
                                   pos, attn_lens, impl=impl)
        h = h + _shared_out(cfg, sp, u, attn)
        h = mamba2.decode_layers(cfg, layers[s:e], h, cache, start=s)
    h = nn.apply_norm(cfg, params["final_norm"], h)
    return nn.unembed(cfg, _head(cfg, params), h), {
        **cache, "lens": (cache["lens"] + 1).to(torch.int32)}
