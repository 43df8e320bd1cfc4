"""mamba2-2.7b — attention-free SSM with state-space duality
[arXiv:2405.21060].

64L d_model=2560, ssm_state=128, expand 2 (d_inner 5120, 80 heads of
headdim 64), vocab 50280. Constant-size decode state (the SSM answer to
a KV cache) — runs long_500k.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50_280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    ssm_expand=2,
    norm="rmsnorm",
    pos="none",
)

SMOKE = CONFIG.replace(
    name="mamba2-2.7b-smoke",
    n_layers=2, d_model=64, vocab=256,
    ssm_state=16, ssm_headdim=16, ssm_chunk=32,
)
