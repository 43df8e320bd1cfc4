"""Encoder-decoder transformer (whisper-large-v3): init, the training
forward and the slot-ring serving path.

Port of the JAX package's ``models/encdec.py``. The audio conv frontend
is a stub there and here: the caller passes the frame embeddings it
would produce, ``frames [B, enc_seq, d_model]``. Downstream:

* the encoder, a stack of bidirectional self-attention layers over the
  frames (one non-causal flash-attention call a layer, ``enc_seq`` x
  ``enc_seq``);
* the decoder, causal self-attention, cross-attention to the encoder
  output (one flash-attention call of the decoder's queries against the
  ``enc_seq`` encoder keys) and an MLP a layer.

Whisper flavour: LayerNorm with bias, tanh-GELU, sinusoidal positions
(added in float32 before the cast to ``cfg.dtype``, as JAX does), tied
embeddings. Per-layer params stay stacked on a leading axis, as in JAX.

Serving keeps, per decoder layer, a self-attention K/V cache
``k``/``v [L, B, max_len, Hk, hd]`` and the static cross-attention K/V
``cross_k``/``cross_v [L, B, enc_seq, Hk, hd]`` that prefill computes
once from the encoder output. :func:`decode_step` writes the self K/V
in place and attends both caches through ``ops.decode_attention``: the
slot decode kernel on the card (the JAX package's form is plain).
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


def init(cfg: ModelConfig, gen: torch.Generator,
         device: "str | torch.device" = "cuda") -> Dict:
    """Random params from ``gen`` with the JAX init's distributions
    (std ``fan_in**-0.5`` projections, 0.02 embeddings, layernorm scale
    1 and bias 0), in ``cfg.dtype`` on ``device``; the encoder and
    decoder layers are drawn layer by layer into stacked leaves
    (``layers.init_stacked``)."""
    device = nn.resolve_device(device)
    params = {
        "embed": {"table": nn.embed_init(gen, (cfg.vocab, cfg.d_model),
                                         nn.dt(cfg), device)},
        "enc_layers": nn.init_stacked(cfg.n_enc_layers, lambda: {
            "ln1": nn.init_norm(cfg, device),
            "attn": nn.init_attention(gen, cfg, device),
            "ln2": nn.init_norm(cfg, device),
            "mlp": nn.init_mlp(gen, cfg, device)}),
        "dec_layers": nn.init_stacked(cfg.n_layers, lambda: {
            "ln1": nn.init_norm(cfg, device),
            "self_attn": {"attn": nn.init_attention(gen, cfg, device)},
            "lnx": nn.init_norm(cfg, device),
            "cross_attn": {"attn": nn.init_attention(gen, cfg, device)},
            "ln2": nn.init_norm(cfg, device),
            "mlp": nn.init_mlp(gen, cfg, device)}),
        "enc_norm": nn.init_norm(cfg, device),
        "final_norm": nn.init_norm(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": nn.embed_init(
            gen, (cfg.vocab, cfg.d_model), nn.dt(cfg), device)}
    return params


def _head(cfg: ModelConfig, params: Dict) -> Dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _with_positions(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, L, d] plus the sinusoidal rows of ``0..L-1``, in float32,
    then in ``cfg.dtype``."""
    pe = nn.sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
    return (x.float() + pe).to(nn.dt(cfg))


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _enc_layer_fwd(cfg: ModelConfig, lp: Dict, h: torch.Tensor, *,
                   impl: str) -> torch.Tensor:
    h = constrain(h, "batch", None, "residual")
    h = h + nn.attention_block(cfg, lp["attn"],
                               nn.apply_norm(cfg, lp["ln1"], h),
                               causal=False, impl=impl)
    return h + nn.mlp_block(cfg, lp["mlp"], nn.apply_norm(cfg, lp["ln2"], h))


def encode(cfg: ModelConfig, params: Dict, frames: torch.Tensor, *,
           remat: bool = False, impl: str = "auto") -> torch.Tensor:
    """frames [B, enc_seq, d_model] (the stub conv output) -> the
    encoder output [B, enc_seq, d_model]: one non-causal flash-attention
    call a layer."""
    x = constrain(_with_positions(cfg, frames), "batch", None, "residual")
    x = nn.run_layers(functools.partial(_enc_layer_fwd, cfg, impl=impl), x,
                      params["enc_layers"], remat=remat)
    return nn.apply_norm(cfg, params["enc_norm"], x)


# ---------------------------------------------------------------------------
# decoder, full sequence (training)
# ---------------------------------------------------------------------------

def _cross_attend(cfg: ModelConfig, lp: Dict, h: torch.Tensor,
                  kx: torch.Tensor, vx: torch.Tensor, *,
                  impl: str) -> torch.Tensor:
    """h plus cross-attention to (kx, vx), then plus the MLP."""
    h = h + nn.attention_block(cfg, lp["cross_attn"]["attn"],
                               nn.apply_norm(cfg, lp["lnx"], h),
                               kv_override=(kx, vx), impl=impl)
    return h + nn.mlp_block(cfg, lp["mlp"], nn.apply_norm(cfg, lp["ln2"], h))


def _dec_layer_fwd(cfg: ModelConfig, lp: Dict, h: torch.Tensor,
                   enc_out: torch.Tensor, *, impl: str) -> torch.Tensor:
    h = constrain(h, "batch", None, "residual")
    h = h + nn.attention_block(cfg, lp["self_attn"]["attn"],
                               nn.apply_norm(cfg, lp["ln1"], h),
                               causal=True, impl=impl)
    kx, vx = nn.cross_kv(lp["cross_attn"]["attn"], enc_out)
    return constrain(_cross_attend(cfg, lp, h, kx, vx, impl=impl),
                     "batch", None, "residual")


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            frames: torch.Tensor, remat: bool = False, impl: str = "auto",
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decode of ``tokens [B, L]`` over the encoded
    ``frames``: (logits [B, L, V], aux 0.0). Three flash-attention calls
    a layer pair (encoder; decoder self and cross); with ``remat`` each
    encoder and decoder layer is recomputed in the backward, so they
    run twice per step."""
    enc_out = encode(cfg, params, frames, remat=remat, impl=impl)
    x = _with_positions(cfg, nn.embed(cfg, params["embed"], tokens))
    body = functools.partial(_dec_layer_fwd, cfg, enc_out=enc_out, impl=impl)
    x = nn.run_layers(body, x, params["dec_layers"], remat=remat)
    x = nn.apply_norm(cfg, params["final_norm"], x)
    return nn.unembed(cfg, _head(cfg, params), x), \
        torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# serving paths
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: "str | torch.device" = "cuda") -> Dict:
    """Zeroed serving state for ``batch`` slots in ``cfg.dtype``: the
    decoder's self K/V ``[L, B, max_len, Hk, hd]``, the cross K/V
    ``[L, B, enc_seq, Hk, hd]``, ``lens [B]`` int32."""
    device = nn.resolve_device(device)
    L, Hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    kw = dict(dtype=nn.dt(cfg), device=device)
    return {
        "k": torch.zeros((L, batch, max_len, Hk, hd), **kw),
        "v": torch.zeros((L, batch, max_len, Hk, hd), **kw),
        "cross_k": torch.zeros((L, batch, cfg.enc_seq, Hk, hd), **kw),
        "cross_v": torch.zeros((L, batch, cfg.enc_seq, Hk, hd), **kw),
        "lens": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            frames: torch.Tensor, max_len: Optional[int] = None,
            impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Encode ``frames`` and run the decoder over ``tokens [B, L]``:
    (last-position logits [B, V], a cache of ``max_len or L`` self
    positions and the cross K/V). Three flash-attention calls a layer
    pair: the encoder's, the decoder's causal self-attention and its
    cross-attention of L queries against ``enc_seq`` keys."""
    enc_out = encode(cfg, params, frames, impl=impl)
    B, L = tokens.shape
    S = max_len or L
    h = _with_positions(cfg, nn.embed(cfg, params["embed"], tokens))
    ks, vs, kxs, vxs = [], [], [], []
    for lp in nn.unstack_layers(params["dec_layers"]):
        sa = lp["self_attn"]["attn"]
        h = constrain(h, "batch", None, "residual")
        q, k, v = nn.qkv_project(sa, nn.apply_norm(cfg, lp["ln1"], h))
        # no softcap here, as in the JAX prefill
        attn = ops.attention(q, k, v, causal=True, impl=impl)
        h = h + nn.merge_heads(attn, sa["wo"])
        kx, vx = nn.cross_kv(lp["cross_attn"]["attn"], enc_out)
        h = _cross_attend(cfg, lp, h, kx, vx, impl=impl)
        for out, t in ((ks, k), (vs, v), (kxs, kx), (vxs, vx)):
            out.append(t.to(nn.dt(cfg)))
    h = nn.apply_norm(cfg, params["final_norm"], h[:, -1])
    logits = nn.unembed(cfg, _head(cfg, params), h)
    pad = (0, 0, 0, 0, 0, S - L)
    return logits, {
        "k": shd.pad(torch.stack(ks), pad),
        "v": shd.pad(torch.stack(vs), pad),
        "cross_k": torch.stack(kxs), "cross_v": torch.stack(vxs),
        "lens": torch.full((B,), L, dtype=torch.int32, device=tokens.device)}


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor,          # [B] current token
                pos: "int | torch.Tensor",     # [] or [B] absolute position
                *, impl: str = "auto",
                ) -> Tuple[torch.Tensor, Dict]:
    """One decoder iteration for every slot: each layer writes its
    token's self K/V at ``pos % S`` (in place) and attends ``min(lens +
    1, S)`` entries, then attends the ``enc_seq`` cross K/V (both
    through ``ops.decode_attention`` by ``impl``). Returns (logits
    [B, V], the cache with new ``lens``)."""
    B = tokens.shape[0]
    x = nn.embed(cfg, params["embed"], tokens)                # [B, d]
    pe = nn.sinusoidal_at(pos, cfg.d_model, x.device)
    h = (x.float() + pe).to(nn.dt(cfg))
    S = cache["k"].shape[2]
    enc_len = torch.full((B,), cfg.enc_seq, dtype=torch.int32,
                         device=x.device)
    new_lens = torch.clamp(cache["lens"] + 1, max=S).to(torch.int32)
    for i, lp in enumerate(nn.unstack_layers(params["dec_layers"])):
        h = constrain(h, "batch", "model")
        h = h + nn.attention_decode(
            cfg, lp["self_attn"]["attn"], nn.apply_norm(cfg, lp["ln1"], h),
            cache["k"][i], cache["v"][i], pos, new_lens, impl=impl)
        h = h + nn.attention_decode(
            cfg, lp["cross_attn"]["attn"], nn.apply_norm(cfg, lp["lnx"], h),
            cache["cross_k"][i], cache["cross_v"][i], pos, enc_len,
            cross=True, impl=impl)
        h = h + nn.mlp_block(cfg, lp["mlp"], nn.apply_norm(cfg, lp["ln2"], h))
    h = nn.apply_norm(cfg, params["final_norm"], h)
    return nn.unembed(cfg, _head(cfg, params), h), {**cache, "lens": new_lens}
