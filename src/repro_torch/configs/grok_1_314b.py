"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab=131_072,
    n_experts=8,
    experts_per_token=2,
    norm="rmsnorm",
    act="geglu",
    pos="rope",
    logit_softcap=30.0,
)

SMOKE = CONFIG.replace(
    name="grok-1-314b-smoke",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=256, n_experts=4, experts_per_token=2,
    moe_group_size=64,
    moe_capacity_factor=8.0,   # no token drops: smoke parity is deterministic
)
