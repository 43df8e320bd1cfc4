"""zamba2-1.2b — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

38L d_model=2048 (d_inner 4096, 64 ssm heads of 64, state 64); the
shared attention block runs at width 2*d_model=4096 with 32 heads of
head_dim 128 (kv=32), d_ff=8192, applied every 6 Mamba layers. vocab
32000. For long_500k the shared attention uses a 4096 sliding window
(DESIGN.md §2 adaptation note).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,            # shared block width 2*d = 4096 = 32 x 128
    d_ff=8192,
    vocab=32_000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    ssm_expand=2,
    attn_every=6,
    sliding_window=4096,
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
)

SMOKE = CONFIG.replace(
    name="zamba2-1.2b-smoke",
    n_layers=4, d_model=32, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=64, vocab=256, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
    attn_every=2, sliding_window=16,
)
