"""llama4-scout-17b-a16e — 16-expert top-1 MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202_048,
    n_experts=16,
    experts_per_token=1,
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
)

SMOKE = CONFIG.replace(
    name="llama4-scout-17b-a16e-smoke",
    n_layers=2, d_model=40, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=80, vocab=256, n_experts=4, experts_per_token=1,
    moe_group_size=64,
    moe_capacity_factor=8.0,   # no token drops: smoke parity is deterministic
)
