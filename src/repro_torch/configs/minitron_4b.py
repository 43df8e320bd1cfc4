"""minitron-4b — pruned Nemotron dense LM [arXiv:2407.14679; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256_000,
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
)

SMOKE = CONFIG.replace(
    name="minitron-4b-smoke",
    n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
    d_ff=96, vocab=256,
)
