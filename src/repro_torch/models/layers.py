"""Dense model building blocks of the port (plain functions on tensors,
params as dicts).

The JAX package's ``models/layers.py`` as the port's models run it:
both transformer serving paths (paged and slot-ring, with the int8 KV
cache's quantisation), the MoE layer, the SSM, hybrid and
encoder-decoder models and the training forwards, with its conventions
and layouts kept:

* attention weights are head-split: wq [d, H, hd], wk/wv [d, Hk, hd],
  wo [H, hd, d]; MLP w1/w3 [d, ff], w2 [ff, d]; MoE experts w1/w3
  [E, d, ff], w2 [E, ff, d] and a float32 router [d, E]; embedding
  table [V, d];
* activations flow in ``cfg.dtype``; norms, rope, sinusoidal positions
  and the router compute in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed import sharding as shd
from ..distributed.sharding import constrain
from ..kernels import ops
from .config import ModelConfig


def dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device a caller asked for; raises when it is CUDA and there
    is none (no entry point moves to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return device


def unstack_layers(layers: Dict) -> List[Dict]:
    """Per-layer views of a params tree stacked on a leading ``L`` axis,
    split once with ``torch.unbind``. Its backward is one ``stack`` per
    leaf; indexing ``w[i]`` in every layer would instead allocate a
    zero-filled gradient of the whole stacked leaf per layer."""
    parts = {k: unstack_layers(v) if isinstance(v, dict) else shd.unbind_layers(v)
             for k, v in layers.items()}
    n = len(next(iter(parts.values())))
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def run_layers(body, x, layers: "Dict | List[Dict]", *, remat: bool):
    """``x = body(lp, x)`` for each layer's params ``lp`` of the stacked
    tree ``layers`` (the JAX ``lax.scan`` over layers), or of a list of
    per-layer trees from :func:`unstack_layers`; ``x`` is a tensor or a
    tuple of tensors (the MoE forward carries its aux loss). With
    ``remat`` each
    layer's activations are recomputed in the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` with
    ``nothing_saveable``), so its kernels run twice per step."""
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    for lp in layers:
        if remat:
            x = checkpoint(lambda h, lp: body(lp, h), x, lp,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = body(lp, x)
    return x


# ---------------------------------------------------------------------------
# init helpers (random draws on an explicit generator; float32, then cast;
# on the meta device nothing is drawn: shapes and dtypes only)
# ---------------------------------------------------------------------------

def init_stacked(n: int, draw_layer) -> Dict:
    """The params of ``n`` layers stacked on a leading axis: layer ``i``
    is drawn by ``draw_layer()`` (a nested dict of tensors) and written
    into its row of leaves allocated on the first draw, so the weights
    are held once (minitron-8b: 19.8 GB in bf16)."""
    def alloc(node):
        if isinstance(node, dict):
            return {k: alloc(v) for k, v in node.items()}
        return node.new_empty((n, *node.shape))

    def write(dst, node, i):
        for k, v in node.items():
            if isinstance(v, dict):
                write(dst[k], v, i)
            else:
                dst[k][i] = v

    stacked = None
    for i in range(n):
        lp = draw_layer()
        if stacked is None:
            stacked = alloc(lp)
        write(stacked, lp, i)
    return stacked


def dense_init(gen: torch.Generator, shape, fan_in: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16,
               device: "str | torch.device" = "cuda") -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = fan_in if fan_in is not None else shape[0]
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device).mul_(fan_in ** -0.5)   # one temporary
    return x.to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, shape,
               dtype: torch.dtype = torch.bfloat16,
               device: "str | torch.device" = "cuda") -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device).mul_(0.02)
    return x.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm scaled by ``(1 + scale)``, computed in float32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm (biased variance), computed in float32."""
    xf = x.float()
    if isinstance(xf, shd.DTensor):
        # sums reduce a sharded d as Partial(sum) stats; DTensor cannot
        # take mean's Partial(avg) back through the backward
        n = xf.shape[-1]
        mu = xf.sum(dim=-1, keepdim=True) / n
        var = torch.square(xf - mu).sum(dim=-1, keepdim=True) / n
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def init_norm(cfg: ModelConfig, device, width: Optional[int] = None) -> Dict:
    """``cfg.norm``'s params over ``width`` (default ``d_model``):
    layernorm scale 1 and bias 0, or the rmsnorm scale 0 (applied as
    ``1 + scale``)."""
    width = width or cfg.d_model
    kw = dict(dtype=dt(cfg), device=device)
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((width,), **kw),
                "bias": torch.zeros((width,), **kw)}
    return {"scale": torch.zeros((width,), **kw)}


def apply_norm(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def rope_freqs(head_dim: int, theta: float,
               device: "str | torch.device") -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half (not interleaved) rotary embedding with float32 angles.
    x: [..., H, D]; positions: ints broadcastable to x.shape[:-2]."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                  # [D/2]
    angles = positions[..., None].float() * freqs           # [..., D/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, d_model: int,
                         device: "str | torch.device") -> torch.Tensor:
    """[length, d_model] float32 rows ``sin(p / 10000**(2i/d)) ||
    cos(...)`` for positions ``0 .. length - 1``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    return _sinusoid(pos, d_model)


def sinusoidal_at(pos: "int | torch.Tensor", d_model: int,
                  device: "str | torch.device") -> torch.Tensor:
    """The sinusoidal row(s) at ``pos`` (a scalar or [B]): [d_model] or
    [B, d_model] float32."""
    posf = torch.as_tensor(pos, device=device).float()[..., None]
    return _sinusoid(posf, d_model)


def _sinusoid(posf: torch.Tensor, d_model: int) -> torch.Tensor:
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=posf.device)
    angle = posf / 10_000.0 ** (dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# attention projections and the MLP
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, device,
                   width: Optional[int] = None) -> Dict:
    """Head-split projections over an input of ``width`` (default
    ``d_model``)."""
    d = width or cfg.d_model
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kw = dict(dtype=dt(cfg), device=device)
    return {
        "wq": dense_init(gen, (d, H, hd), fan_in=d, **kw),
        "wk": dense_init(gen, (d, Hk, hd), fan_in=d, **kw),
        "wv": dense_init(gen, (d, Hk, hd), fan_in=d, **kw),
        "wo": dense_init(gen, (H, hd, d), fan_in=H * hd, **kw),
    }


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d] @ w [d, heads, hd] -> [..., heads, hd]."""
    return shd.unflatten(x @ shd.flatten(w, 1, 2), -1, w.shape[1:])


def merge_heads(x: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """x [..., H, hd] @ wo [H, hd, d] -> [..., d]."""
    return shd.flatten(x, -2, -1) @ shd.flatten(wo, 0, 1)


def qkv_project(p: Dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = (project_heads(x, p["wq"]), project_heads(x, p["wk"]),
               project_heads(x, p["wv"]))
    if x.ndim == 3:
        q = constrain(q, "batch", None, "model", None)
        k = constrain(k, "batch", None, "model", None)
        v = constrain(v, "batch", None, "model", None)
    return q, k, v


def attention_block(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    prefix_len: int = 0,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Full-sequence attention (training, prefill), x [B, L, width]:
    project, rope at ``0..L-1``, one flash-attention call (``causal``,
    within ``window``, the first ``prefix_len`` keys visible to every
    query when causal: prefix-LM), merge the heads. Returns [B, L,
    width]. With ``kv_override`` (cross-attention: K/V ``[B, Lk, Hk,
    hd]`` from :func:`cross_kv`) only q is projected, without rope, and
    attention is not causal. (The JAX layer's ``positions`` argument is
    never passed by a model: rope runs at ``0..L-1``.)"""
    B, L, _ = x.shape
    if kv_override is None:
        q, k, v = qkv_project(p, x)
        if cfg.pos == "rope":
            pos = torch.arange(L, device=x.device)[None].expand(B, L)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
    else:
        q = constrain(project_heads(x, p["wq"]), "batch", None, "model", None)
        k, v = kv_override
        causal = False
    out = ops.attention(q, k, v, causal=causal, window=window,
                        logit_softcap=cfg.logit_softcap, impl=impl,
                        prefix_len=prefix_len if causal else 0)
    return constrain(merge_heads(out, p["wo"]), "batch", None, None)


def cross_kv(p: Dict, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V ``[B, Le, Hk, hd]`` of the encoder output
    ``enc_out [B, Le, d]`` (computed once a prefill, then cached)."""
    return project_heads(enc_out, p["wk"]), project_heads(enc_out, p["wv"])


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation per (.., head) over the head_dim:
    returns (int8 values, float32 scales of shape ``x.shape[:-1]``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def attention_decode(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                    # [B, d] one token per sequence
    k_cache: torch.Tensor,              # [B, S, Hk, hd]
    v_cache: torch.Tensor,
    pos: "int | torch.Tensor",          # [] or [B] absolute position
    cache_len: torch.Tensor,            # [B] valid entries AFTER this write
    *,
    cross: bool = False,
    kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Cached single-token decode. Writes the new K/V into ring slot
    ``pos % S`` of the caches (in place; ``pos`` a scalar for a lockstep
    batch or one position per slot), then attends over the valid cache.
    With ``kv_scales`` (the int8 cache, in place too) the new entry is
    quantised on write and the cache dequantised to q's dtype for
    attention. With ``cross`` the caches are the static cross-attention
    K/V: only q is projected, nothing is written, and ``cache_len`` is
    the encoder's length. ``impl`` goes to ``ops.decode_attention``.
    Returns out [B, d]."""
    B = x.shape[0]
    S = k_cache.shape[1]
    pos = torch.as_tensor(pos, device=x.device).long()
    if cross:
        q = project_heads(x, p["wq"])
        if cfg.pos == "rope":
            q = apply_rope(q, pos.expand(B), cfg.rope_theta)
        out = ops.decode_attention(q, k_cache, v_cache, cache_len,
                                   logit_softcap=cfg.logit_softcap, impl=impl)
        return merge_heads(out, p["wo"])
    q, k_new, v_new = qkv_project(p, x)              # [B, H|Hk, hd]
    if cfg.pos == "rope":
        posb = pos.expand(B)
        q = apply_rope(q, posb, cfg.rope_theta)
        k_new = apply_rope(k_new, posb, cfg.rope_theta)
    if kv_scales is not None:
        k_new, ks_new = quantize_kv(k_new)
        v_new, vs_new = quantize_kv(v_new)
    slot = pos % S                                   # ring when S < max_len
    # an index_put with tensor indices: no host sync, and it runs on meta
    caches, news = [k_cache, v_cache], [k_new, v_new]
    if kv_scales is not None:
        caches += list(kv_scales)
        news += [ks_new, vs_new]
    shd.write_rows(caches, slot, news)
    if kv_scales is not None:
        k_attn = dequantize_kv(k_cache, kv_scales[0]).to(q.dtype)
        v_attn = dequantize_kv(v_cache, kv_scales[1]).to(q.dtype)
    else:
        k_attn, v_attn = k_cache, v_cache
    # a ring cache holds only positions inside the window, so no window
    # mask is applied here (the JAX layer passes window=None too)
    out = ops.decode_attention(q, k_attn, v_attn, cache_len,
                               logit_softcap=cfg.logit_softcap, window=None,
                               impl=impl)
    return merge_heads(out, p["wo"])


def init_mlp(gen, cfg: ModelConfig, device,
             width: Optional[int] = None) -> Dict:
    d, ff = width or cfg.d_model, cfg.d_ff
    kw = dict(dtype=dt(cfg), device=device)
    p = {"w1": dense_init(gen, (d, ff), **kw),
         "w2": dense_init(gen, (ff, d), **kw)}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = dense_init(gen, (d, ff), **kw)
    return p


def mlp_block(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w1"]
    h = constrain(h, "batch", None, "model") if h.ndim == 3 else h
    if cfg.act == "swiglu":
        h = F.silu(h) * (x @ p["w3"])
    elif cfg.act == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")
    out = h @ p["w2"]
    return constrain(out, "batch", None, None) if out.ndim == 3 else out


# ---------------------------------------------------------------------------
# Mixture-of-Experts (grouped capacity dispatch)
# ---------------------------------------------------------------------------

def init_moe(gen, cfg: ModelConfig, device) -> Dict:
    """One MoE layer: a float32 router [d, E] and the experts' stacked
    MLP weights (``fan_in`` d for w1/w3, ff for w2), as the JAX
    ``init_moe`` lays them out."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(dtype=dt(cfg), device=device)
    p = {"router": dense_init(gen, (d, E), dtype=torch.float32,
                              device=device),
         "w1": dense_init(gen, (E, d, ff), fan_in=d, **kw),
         "w2": dense_init(gen, (E, ff, d), fan_in=ff, **kw)}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = dense_init(gen, (E, d, ff), fan_in=d, **kw)
    return p


def moe_route(cfg: ModelConfig, p: Dict, xg: torch.Tensor) -> Dict:
    """The router of one MoE layer over token groups xg [G, g, d], as
    the JAX ``moe_block`` computes it: float32 logits and softmax; the
    top ``K`` experts of each token (ties to the lower index, as
    ``jax.lax.top_k``: a stable descending sort), their probabilities
    renormalised over the ``K``; each (token, k)'s place in its expert
    from the exclusive cumsum of the one-hots flattened token-major over
    the group; the entries at or past the capacity
    ``max(ceil(g K / E * cf), 4)`` dropped. Returns ``probs`` [G, g, E],
    ``top_e`` and ``top_p`` [G, g, K], the one-hots ``onehot`` [G, g, K,
    E], the place ``pos_sel`` and the kept mask ``keep`` [G, g, K]
    (float32 0/1), and ``capacity``."""
    G, g, _ = xg.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(xg.float() @ p["router"], dim=-1)     # [G, g, E]
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    capacity = max(int(math.ceil(g * K / E * cfg.moe_capacity_factor)), 4)
    onehot = F.one_hot(top_e, E).float()                         # [G, g, K, E]
    flat = onehot.reshape(G, g * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, g, K, E)
    pos_sel = (pos * onehot).sum(-1)                             # [G, g, K]
    keep = (onehot * (pos < capacity)).sum(-1)                   # [G, g, K]
    return dict(probs=probs, top_e=top_e, top_p=top_p, onehot=onehot,
                pos_sel=pos_sel, keep=keep, capacity=capacity)


def _bmm_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The four einsums of :func:`moe_block` as batched products over
    the group axis, for DTensors: DTensor's einsum decomposes into views
    that merge a sharded dim into another, which some versions refuse."""
    if eq == "gtke,gtkc->gtec":          # [G, g, K, E] x [G, g, K, C]
        G, g, K, E = a.shape
        C = b.shape[-1]
        out = torch.bmm(a.reshape(G * g, K, E).transpose(1, 2),
                        b.reshape(G * g, K, C))
        return out.reshape(G, g, E, C)
    if eq == "gtec,gtd->egcd":           # [G, g, E, C] x [G, g, d]
        G, g, E, C = a.shape
        out = torch.bmm(a.reshape(G, g, E * C).transpose(1, 2), b)
        return out.reshape(G, E, C, b.shape[-1]).permute(1, 0, 2, 3)
    if eq == "gtec,egcd->gtd":           # [G, g, E, C] x [E, G, C, d]
        G, g, E, C = a.shape
        return torch.bmm(a.reshape(G, g, E * C),
                         b.permute(1, 0, 2, 3).reshape(G, E * C, b.shape[-1]))
    raise ValueError(eq)


def moe_block(cfg: ModelConfig, p: Dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts with capacity-bounded grouped dispatch, x
    [B, L, d]: the tokens (padded with zero rows to whole groups of
    ``min(moe_group_size, B L)``) routed by :func:`moe_route`, gathered
    per expert through the dispatch tensor [G, g, E, C] in
    ``cfg.dtype``, the expert MLPs as batched products over the expert
    axis on [E, G C, d] (the stacked weights used in place), and the
    outputs weighted back by the combine tensor. Returns (out [B, L, d],
    the Switch load-balance aux loss in float32, whose densities and
    mean probabilities include the pad rows, as in JAX)."""
    B, L, d = x.shape
    E = cfg.n_experts
    T = B * L
    g = min(cfg.moe_group_size, T)
    G = -(-T // g)
    xt = x.reshape(T, d)
    if G * g > T:
        xt = shd.pad(xt, (0, 0, 0, G * g - T))
    xg = constrain(xt.reshape(G, g, d), "batch", None, None)
    r = moe_route(cfg, p, xg)
    C = r["capacity"]
    # a dropped entry's place is >= C: its one-hot row over C is zero
    # (jax.nn.one_hot's), masked here by keep instead of F.one_hot
    cap_oh = F.one_hot(r["pos_sel"].long().clamp(max=C - 1), C).float()
    cap_oh = cap_oh * r["keep"][..., None]                       # [G, g, K, C]
    ein = torch.einsum if not isinstance(xg, shd.DTensor) else _bmm_einsum
    disp = ein("gtke,gtkc->gtec", r["onehot"], cap_oh)
    comb = ein("gtke,gtkc->gtec", r["onehot"], cap_oh * r["top_p"][..., None])
    xe = ein("gtec,gtd->egcd", disp.to(dt(cfg)), xg)             # [E, G, C, d]
    # JAX's [G, E, C, d] constraint, on the port's expert-major layout
    xe = constrain(xe, "expert", "batch", None, None).reshape(E, G * C, d)
    h = torch.bmm(xe, p["w1"])                                   # [E, G C, ff]
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.bmm(xe, p["w3"])
    elif cfg.act == "geglu":
        h = F.gelu(h, approximate="tanh") * torch.bmm(xe, p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")
    ye = torch.bmm(h, p["w2"]).reshape(E, G, C, d)
    ye = constrain(ye, "expert", "batch", None, None)
    out = ein("gtec,egcd->gtd", comb.to(dt(cfg)), ye)
    out = constrain(out.reshape(G * g, d)[:T].reshape(B, L, d),
                    "batch", None, None)
    density = r["onehot"].sum(2).mean(dim=1)                     # [G, E]
    router_prob = r["probs"].mean(dim=1)                         # [G, E]
    aux = (density * router_prob).sum(-1).mean() * E
    return out, aux.float()


def moe_block_decode(cfg: ModelConfig, p: Dict,
                     x: torch.Tensor) -> torch.Tensor:
    """Decode-path MoE for single tokens x [B, d]: one group of all B
    rows (the idle slots' rows too) at capacity factor 2.0."""
    out, _ = moe_block(cfg.replace(moe_group_size=x.shape[0],
                                   moe_capacity_factor=2.0), p, x[:, None, :])
    return out[:, 0, :]


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed(cfg: ModelConfig, p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    x = shd.embedding(p["table"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    # on a mesh the table is gathered on d first, so its gradient comes
    # back on its own placement, as the lookup's does (a tied table adds
    # the two)
    logits = x @ shd.only_split(p["table"], 0).T
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
