"""Dense model building blocks of the port (plain functions on tensors,
params as dicts).

The subset of the JAX package's ``models/layers.py`` the dense paged
serving path runs, with its conventions and layouts kept:

* attention weights are head-split: wq [d, H, hd], wk/wv [d, Hk, hd],
  wo [H, hd, d]; MLP w1/w3 [d, ff], w2 [ff, d]; embedding table [V, d];
* activations flow in ``cfg.dtype``; norms and rope compute in float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# init helpers (random draws on an explicit generator; float32, then cast)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, fan_in: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16,
               device: "str | torch.device" = "cuda") -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * fan_in ** -0.5
    return x.to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, shape,
               dtype: torch.dtype = torch.bfloat16,
               device: "str | torch.device" = "cuda") -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * 0.02
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


# ---------------------------------------------------------------------------
# attention projections and the MLP
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, device) -> Dict:
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kw = dict(dtype=dt(cfg), device=device)
    return {
        "wq": dense_init(gen, (d, H, hd), fan_in=d, **kw),
        "wk": dense_init(gen, (d, Hk, hd), fan_in=d, **kw),
        "wv": dense_init(gen, (d, Hk, hd), fan_in=d, **kw),
        "wo": dense_init(gen, (H, hd, d), fan_in=H * hd, **kw),
    }


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d] @ w [d, heads, hd] -> [..., heads, hd]."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def merge_heads(x: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """x [..., H, hd] @ wo [H, hd, d] -> [..., d]."""
    return x.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def qkv_project(p: Dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (project_heads(x, p["wq"]), project_heads(x, p["wk"]),
            project_heads(x, p["wv"]))


def init_mlp(gen, cfg: ModelConfig, device) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dt(cfg), device=device)
    p = {"w1": dense_init(gen, (d, ff), **kw),
         "w2": dense_init(gen, (ff, d), **kw)}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = dense_init(gen, (d, ff), **kw)
    return p


def mlp_block(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w1"]
    if cfg.act == "swiglu":
        h = F.silu(h) * (x @ p["w3"])
    elif cfg.act == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed(cfg: ModelConfig, p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    x = p["table"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    logits = x @ p["table"].T
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
