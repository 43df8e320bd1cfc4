"""Mamba-2 (SSD) model, the attention-free family (mamba2-2.7b): init,
the full-sequence forward the trainer runs, and the serving paths.

Port of the JAX package's ``models/mamba2.py``. Block: in_proj split as
``w_z | w_x | w_b | w_c | w_dt``; causal depthwise conv + SiLU on each of
the x, B and C segments (per-segment conv weights ``[k, C]``); the SSD
scan (``ops.ssd``, the B5 kernel on CUDA tensors) with per-head A and
the D skip; gated RMSNorm; ``out_proj``. Per-layer params stay stacked
on a leading ``L`` axis (the JAX layout, so the tests compare like with
like); the layer ``lax.scan`` becomes a Python loop. ``A_log``, ``D``
and ``dt_bias`` are float32 whatever ``cfg.dtype`` is, as in JAX.

Serving keeps O(1) state per layer and slot (``init_cache``): a
``[k-1, conv_dim]`` ring of the pre-conv ``x | B | C`` segments in the
model dtype and the ``[H, P, N]`` SSM state in float32. ``prefill``
runs the plain ``ref.ssd_chunked`` with its final state (as the JAX
prefill does; the B5 kernel returns no state); ``decode_step`` advances
every slot one token through ``ops.ssm_decode_step`` and writes both
states in place (the JAX function returns a new cache).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import sharding as shd
from ..distributed.sharding import constrain
from ..kernels import ops
from . import layers as nn
from .config import ModelConfig


def _split_sizes(cfg: ModelConfig):
    return cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_heads


def init(cfg: ModelConfig, gen: torch.Generator,
         device: "str | torch.device" = "cuda") -> Dict:
    """Random params from ``gen`` with the JAX init's distributions
    (std ``fan_in**-0.5`` projections, ``k**-0.5`` conv weights, zero
    biases and norm scales, 0.02 embeddings, ``A_log = log(1..H)``,
    ``D = 1``, ``dt_bias`` the inverse softplus of a log-uniform dt in
    [1e-3, 1e-1]). Each leaf is drawn for all ``L`` layers at once on
    ``gen``'s device, then moved to ``device`` in ``cfg.dtype``."""
    device = nn.resolve_device(device)
    din, gn, H = _split_sizes(cfg)
    d, L, k = cfg.d_model, cfg.n_layers, cfg.ssm_conv
    wdt = nn.dt(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    def dense(shape):
        return nn.dense_init(gen, (L, *shape), fan_in=shape[0], dtype=wdt,
                             device=device)

    def conv_w(width):
        return nn.dense_init(gen, (L, k, width), fan_in=k, dtype=wdt,
                             device=device)

    def zeros(width):
        return torch.zeros((L, width), dtype=wdt, device=device)

    u = torch.empty((L, H), **f32) if device.type == "meta" else \
        torch.rand((L, H), generator=gen, dtype=torch.float32,
                   device=gen.device).to(device)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))   # inverse softplus
    norm = nn.init_norm(cfg, device)
    layers = {
        "ln": {name: w.expand(L, -1).clone() for name, w in norm.items()},
        "ssm": {
            "w_z": dense((d, din)),
            "w_x": dense((d, din)),
            "w_b": dense((d, gn)),
            "w_c": dense((d, gn)),
            "w_dt": dense((d, H)),
            "conv_x_w": conv_w(din),
            "conv_x_b": zeros(din),
            "conv_b_w": conv_w(gn),
            "conv_b_b": zeros(gn),
            "conv_c_w": conv_w(gn),
            "conv_c_b": zeros(gn),
            "A_log": torch.log(torch.arange(1, H + 1, **f32)).expand(L, H).clone(),
            "D": torch.ones((L, H), **f32),
            "dt_bias": dt_bias,
            "gate_norm": zeros(din),
            "out_proj": dense((din, d)),
        },
    }
    params = {
        "embed": {"table": nn.embed_init(gen, (cfg.vocab, d), wdt, device)},
        "layers": layers,
        "final_norm": nn.init_norm(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": nn.embed_init(gen, (cfg.vocab, d), wdt,
                                                    device)}
    return params


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, x [B, L, C], w [k, C], b [C]: ``k``
    shifted multiply-adds in float32 (exact, and no TF32 as a cuDNN
    convolution would take by default on the card)."""
    k, L = w.shape[0], x.shape[1]
    xp = shd.pad(x.float(), (0, 0, k - 1, 0))
    wf = w.float()
    out = xp[:, 0:L] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i:i + L] * wf[i]
    return (out + b.float()).to(x.dtype)


def _ssm_pre(cfg: ModelConfig, sp: Dict, x: torch.Tensor):
    """Split input projections: x [B, L, d] -> (z, xs, b_raw, c_raw,
    dt_raw), all before the conv."""
    z, xs = x @ sp["w_z"], x @ sp["w_x"]
    if x.ndim == 3:
        z = constrain(z, "batch", None, "model")
        xs = constrain(xs, "batch", None, "model")
    return z, xs, x @ sp["w_b"], x @ sp["w_c"], x @ sp["w_dt"]


def _ssd_inputs(cfg: ModelConfig, sp: Dict, xs: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, dt_raw: torch.Tensor):
    """Discretise the post-conv segments. Returns (xh, a, b, c, x_heads,
    dt): ``xh`` the dt-scaled heads and ``a`` the log decays, both in
    xs's dtype."""
    _, _, H = _split_sizes(cfg)
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    b = b.unflatten(-1, (G, N))
    c = c.unflatten(-1, (G, N))
    dt = F.softplus(dt_raw.float() + sp["dt_bias"])
    a = -torch.exp(sp["A_log"]) * dt                     # [..., H] log decay
    x_heads = xs.unflatten(-1, (H, P))
    if x_heads.ndim == 4:
        x_heads = constrain(x_heads, "batch", None, "model", None)
    xh = (x_heads.float() * dt[..., None]).to(xs.dtype)
    return xh, a.to(xs.dtype), b, c, x_heads, dt


def _gated_out(cfg: ModelConfig, sp: Dict, y_heads: torch.Tensor,
               z: torch.Tensor, x_heads: torch.Tensor) -> torch.Tensor:
    """D skip + gated RMSNorm + out_proj. y/x [.., H, P], z [.., din]."""
    y = y_heads.float() + sp["D"][..., None] * x_heads.float()
    y = y.reshape(z.shape)
    y = y * F.silu(z.float())
    y = nn.rms_norm(y.to(z.dtype), sp["gate_norm"])
    return y @ sp["out_proj"]


def layer_fwd(cfg: ModelConfig, lp: Dict, h: torch.Tensor, *,
              impl: str = "auto") -> torch.Tensor:
    """One Mamba-2 block over the full sequence, h [B, L, d]."""
    sp = lp["ssm"]
    x = nn.apply_norm(cfg, lp["ln"], h)
    z, xs, b, c, dt_raw = _ssm_pre(cfg, sp, x)
    xs = F.silu(_causal_conv(xs, sp["conv_x_w"], sp["conv_x_b"]))
    b = F.silu(_causal_conv(b, sp["conv_b_w"], sp["conv_b_b"]))
    c = F.silu(_causal_conv(c, sp["conv_c_w"], sp["conv_c_b"]))
    xh, a, b, c, x_heads, _ = _ssd_inputs(cfg, sp, xs, b, c, dt_raw)
    y = ops.ssd(xh, a, b, c, chunk=cfg.ssm_chunk, impl=impl)
    return h + constrain(_gated_out(cfg, sp, y, z, x_heads),
                         "batch", None, None)


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            remat: bool = False, impl: str = "auto",
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits [B, L, V], aux 0.0). With
    ``remat`` the SSD kernel runs twice per layer and step (forward and
    recompute, see ``layers.run_layers``)."""
    # residual stream replicated on d (batch-sharded only): every layer
    # then costs one row-parallel all-reduce (out_proj)
    x = constrain(nn.embed(cfg, params["embed"], tokens), "batch", None, None)
    x = nn.run_layers(functools.partial(layer_fwd, cfg, impl=impl), x,
                      params["layers"], remat=remat)
    x = nn.apply_norm(cfg, params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return nn.unembed(cfg, head, x), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# serving paths: O(1) decode state
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: "str | torch.device" = "cuda") -> Dict:
    """Zeroed decode state for ``batch`` slots (``max_len`` unused: the
    state is constant-size): ``conv [L, B, k-1, conv_dim]`` in
    ``cfg.dtype``, ``ssm [L, B, H, P, N]`` float32, ``lens [B]`` int32."""
    del max_len
    device = nn.resolve_device(device)
    L, H, P, N = cfg.n_layers, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    return {
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, cfg.conv_dim),
                            dtype=nn.dt(cfg), device=device),
        "ssm": torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                           device=device),
        "lens": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _layer_prefill(cfg: ModelConfig, lp: Dict, h: torch.Tensor):
    """``layer_fwd`` that also returns (conv_state [B, k-1, conv_dim],
    ssm_state [B, H, P, N]). The conv ring holds the last ``k - 1``
    pre-conv ``xs | b | c`` rows, concatenated (decode re-splits them at
    fixed offsets). The scan is the plain ``ref.ssd_chunked`` with its
    final state."""
    sp = lp["ssm"]
    x = nn.apply_norm(cfg, lp["ln"], h)
    z, xs, b, c, dt_raw = _ssm_pre(cfg, sp, x)
    tail = slice(-(cfg.ssm_conv - 1), None)
    conv_state = torch.cat([xs[:, tail], b[:, tail], c[:, tail]],
                           dim=-1).to(nn.dt(cfg))
    xs = F.silu(_causal_conv(xs, sp["conv_x_w"], sp["conv_x_b"]))
    b = F.silu(_causal_conv(b, sp["conv_b_w"], sp["conv_b_b"]))
    c = F.silu(_causal_conv(c, sp["conv_c_w"], sp["conv_c_b"]))
    xh, a, b, c, x_heads, _ = _ssd_inputs(cfg, sp, xs, b, c, dt_raw)
    y, state = ops.ssd_with_state(xh, a, b, c, chunk=cfg.ssm_chunk)
    return h + _gated_out(cfg, sp, y, z, x_heads), (conv_state, state)


def prefill_layers(cfg: ModelConfig, layers, h: torch.Tensor,
                   conv: list, ssm: list) -> torch.Tensor:
    """``h`` through the per-layer trees ``layers`` with
    :func:`_layer_prefill`, each layer's states appended to ``conv`` and
    ``ssm``."""
    for lp in layers:
        h, (conv_s, ssm_s) = _layer_prefill(cfg, lp, h)
        conv.append(conv_s)
        ssm.append(ssm_s)
    return h


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, impl: str = "auto",
            ) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt ``tokens`` [B, L]: (last-position logits
    [B, V], a filled cache). A prompt shorter than ``k - 1`` tokens is
    not supported (as in JAX, the conv ring takes the last ``k - 1``
    rows). ``max_len`` and ``impl`` are accepted for the registry's
    uniform signature; no kernel runs here."""
    del max_len, impl
    B, L = tokens.shape
    h = nn.embed(cfg, params["embed"], tokens)
    conv, ssm = [], []
    h = prefill_layers(cfg, nn.unstack_layers(params["layers"]), h, conv, ssm)
    h = nn.apply_norm(cfg, params["final_norm"], h[:, L - 1])
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return nn.unembed(cfg, head, h), {
        "conv": torch.stack(conv), "ssm": torch.stack(ssm),
        "lens": torch.full((B,), L, dtype=torch.int32, device=tokens.device)}


def decode_layer(cfg: ModelConfig, lp: Dict, h: torch.Tensor,
                 conv_st: torch.Tensor, ssm_st: torch.Tensor):
    """One token through one Mamba block (shared with the hybrid
    family), h [B, d]; conv_st [B, k-1, conv_dim] is the ring of
    pre-conv ``xs | b | c`` rows. Returns (h', (new conv ring, new SSM
    state)). As in JAX, the three conv weights and biases are
    concatenated on every call."""
    B = h.shape[0]
    din, gn, H = _split_sizes(cfg)
    G, N, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    sp = lp["ssm"]
    xn = nn.apply_norm(cfg, lp["ln"], h)
    z, xs_t, b_t, c_t, dt_raw = _ssm_pre(cfg, sp, xn)
    seg_t = torch.cat([xs_t, b_t, c_t], dim=-1)          # [B, conv_dim]
    win = torch.cat([conv_st.float(), seg_t[:, None, :].float()], dim=1)
    conv_w = torch.cat([sp["conv_x_w"], sp["conv_b_w"], sp["conv_c_w"]],
                       dim=-1).float()
    conv_b = torch.cat([sp["conv_x_b"], sp["conv_b_b"], sp["conv_c_b"]],
                       dim=-1).float()
    conv_out = torch.einsum("bkc,kc->bc", win, conv_w) + conv_b
    seg = F.silu(conv_out).to(xn.dtype)                  # [B, conv_dim]
    new_conv = win[:, 1:].to(conv_st.dtype)

    b = seg[..., din:din + gn].reshape(B, G, N)
    c = seg[..., din + gn:].reshape(B, G, N)
    dt = F.softplus(dt_raw.float() + sp["dt_bias"])
    a = -torch.exp(sp["A_log"]) * dt                     # [B, H]
    x_heads = seg[..., :din].reshape(B, H, P)
    xh = (x_heads.float() * dt[..., None]).to(seg.dtype)
    y, new_ssm = ops.ssm_decode_step(ssm_st, xh, a, b, c)
    return h + _gated_out(cfg, sp, y, z, x_heads), (new_conv, new_ssm)


def decode_layers(cfg: ModelConfig, layers, h: torch.Tensor, cache: Dict,
                  start: int = 0) -> torch.Tensor:
    """``h`` [B, d] through the per-layer trees ``layers``, the Mamba
    layers ``start, start + 1, ...`` of ``cache``, whose ``conv`` and
    ``ssm`` rows are written in place."""
    for j, lp in enumerate(layers, start):
        h, (conv_s, ssm_s) = decode_layer(cfg, lp, h, cache["conv"][j],
                                          cache["ssm"][j])
        cache["conv"][j].copy_(conv_s)
        cache["ssm"][j].copy_(ssm_s)
    return h


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor,          # [B] current token
                pos: "int | torch.Tensor",     # unused: the state is O(1)
                *, impl: str = "auto",
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode iteration for every slot: (logits [B, V], the cache
    with its conv and SSM states written in place and ``lens + 1``).
    ``impl`` is taken for the other families' signature: the SSM state
    update is plain on every device."""
    del pos, impl
    h = nn.embed(cfg, params["embed"], tokens)           # [B, d]
    h = decode_layers(cfg, nn.unstack_layers(params["layers"]), h, cache)
    h = nn.apply_norm(cfg, params["final_norm"], h)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return nn.unembed(cfg, head, h), {
        **cache, "lens": (cache["lens"] + 1).to(torch.int32)}
