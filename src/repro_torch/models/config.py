"""Unified model configuration covering all ten assigned architectures.

One dataclass, one ``family`` switch: dense | moe | ssm | hybrid |
encdec | vlm. Family-irrelevant fields are ignored by the other
families. Exact per-arch values live in ``repro.configs.<arch>``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None         # default d_model // n_heads

    # --- attention / transformer ---
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # SWA (h2o-danube); also the
                                           # long-context fallback for hybrids
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    act: str = "swiglu"                    # swiglu | geglu | gelu
    pos: str = "rope"                      # rope | sinusoidal | none
    logit_softcap: Optional[float] = None
    embed_scale: bool = False              # gemma-style sqrt(d) embedding scale
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024             # dispatch group (tokens)
    router_aux_coef: float = 0.01

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0                     # N
    ssm_headdim: int = 64                  # P
    ssm_ngroups: int = 1                   # G
    ssm_chunk: int = 256                   # Q
    ssm_conv: int = 4                      # depthwise conv kernel
    ssm_expand: int = 2                    # d_inner = expand * d_model

    # --- hybrid (zamba2): shared attention block every N ssm layers ---
    attn_every: int = 0

    # --- enc-dec (whisper): encoder depth + stub frontend length ---
    n_enc_layers: int = 0
    enc_seq: int = 0                       # 1500 post-conv audio frames

    # --- vlm (paligemma): stub patch-prefix length, prefix-LM masking ---
    prefix_len: int = 0

    dtype: str = "bfloat16"
    # KV-cache quantisation for serving: "bfloat16" (default) or "int8"
    # (per-entry symmetric scales; halves cache HBM traffic + capacity)
    kv_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_head(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        # channels that pass through the depthwise conv: x, B, C
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode state: SSM, hybrid, or sliding-window."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- parameter count (for 6ND model-FLOPs and memory budgeting) ---
    def param_count(self) -> int:
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, H, Hk = self.d_head, self.n_heads, self.n_kv_heads

        def attn_params(width: int, heads: int, kv: int, head_dim: int) -> int:
            return width * head_dim * (heads + kv) + width * head_dim * kv + heads * head_dim * width

        def mlp_params(width: int, hidden: int, gated: bool) -> int:
            return width * hidden * (3 if gated else 2)

        gated = self.act in ("swiglu", "geglu")
        n = V * d                                     # embeddings
        if not self.tie_embeddings:
            n += V * d                                # lm_head
        if self.family in ("dense", "vlm"):
            per = attn_params(d, H, Hk, hd) + mlp_params(d, ff, gated) + 2 * d
            n += L * per
        elif self.family == "moe":
            per = attn_params(d, H, Hk, hd) + 2 * d
            per += d * self.n_experts                 # router
            per += self.n_experts * mlp_params(d, ff, gated)
            n += L * per
        elif self.family == "ssm":
            din, G, N, Hs = self.d_inner, self.ssm_ngroups, self.ssm_state, self.ssm_heads
            per = d * (2 * din + 2 * G * N + Hs)      # in_proj
            per += self.ssm_conv * self.conv_dim      # conv
            per += 3 * Hs                             # A_log, D, dt_bias
            per += din                                # gated norm
            per += din * d                            # out_proj
            per += d                                  # pre-norm
            n += L * per
        elif self.family == "hybrid":
            din, G, N, Hs = self.d_inner, self.ssm_ngroups, self.ssm_state, self.ssm_heads
            per = d * (2 * din + 2 * G * N + Hs) + self.ssm_conv * self.conv_dim
            per += 3 * Hs + din + din * d + d
            n += L * per
            # one shared attention block at width 2d + down-projection
            w = 2 * d
            n += attn_params(w, H, Hk, hd) + mlp_params(w, ff, gated) + 2 * w + w * d
        elif self.family == "encdec":
            per_enc = attn_params(d, H, Hk, hd) + mlp_params(d, ff, gated) + 2 * d
            per_dec = 2 * attn_params(d, H, Hk, hd) + mlp_params(d, ff, gated) + 3 * d
            n += self.n_enc_layers * per_enc + L * per_dec
        n += d                                        # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: selected experts only)."""
        if self.family != "moe":
            return self.param_count()
        gated = self.act in ("swiglu", "geglu")
        dense_experts = self.n_experts * self.d_model * self.d_ff * (3 if gated else 2)
        active_experts = self.experts_per_token * self.d_model * self.d_ff * (3 if gated else 2)
        return self.param_count() - self.n_layers * (dense_experts - active_experts)
