"""Mamba-2 (SSD) model, the attention-free family (mamba2-2.7b): init
and the full-sequence forward the trainer runs.

Port of the JAX package's ``models/mamba2.py``. Block: in_proj split as
``w_z | w_x | w_b | w_c | w_dt``; causal depthwise conv + SiLU on each of
the x, B and C segments (per-segment conv weights ``[k, C]``); the SSD
scan (``ops.ssd``, the B5 kernel on CUDA tensors) with per-head A and
the D skip; gated RMSNorm; ``out_proj``. Per-layer params stay stacked
on a leading ``L`` axis (the JAX layout, so the tests compare like with
like); the layer ``lax.scan`` becomes a Python loop. ``A_log``, ``D``
and ``dt_bias`` are float32 whatever ``cfg.dtype`` is, as in JAX.

The serving paths (``prefill``, ``decode_step``, ``init_cache``) come
with the SSM serving slice (ROADMAP.md, A8).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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

    u = torch.rand((L, H), generator=gen, dtype=torch.float32,
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
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    wf = w.float()
    out = xp[:, 0:L] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i:i + L] * wf[i]
    return (out + b.float()).to(x.dtype)


def _ssm_pre(cfg: ModelConfig, sp: Dict, x: torch.Tensor):
    """Split input projections: x [B, L, d] -> (z, xs, b_raw, c_raw,
    dt_raw), all before the conv."""
    return (x @ sp["w_z"], x @ sp["w_x"], x @ sp["w_b"], x @ sp["w_c"],
            x @ sp["w_dt"])


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
    return h + _gated_out(cfg, sp, y, z, x_heads)


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            remat: bool = False, impl: str = "auto",
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits [B, L, V], aux 0.0). With
    ``remat`` the SSD kernel runs twice per layer and step (forward and
    recompute, see ``layers.run_layers``)."""
    x = nn.embed(cfg, params["embed"], tokens)
    x = nn.run_layers(functools.partial(layer_fwd, cfg, impl=impl), x,
                      params["layers"], remat=remat)
    x = nn.apply_norm(cfg, params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return nn.unembed(cfg, head, x), torch.zeros((), device=x.device)
