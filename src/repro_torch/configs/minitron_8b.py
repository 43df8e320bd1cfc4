"""minitron-8b — pruned Nemotron dense LM [arXiv:2407.14679; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256_000,
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
)

SMOKE = CONFIG.replace(
    name="minitron-8b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
)
