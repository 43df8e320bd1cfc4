"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
The sliding window bounds the decode cache to the window, so this dense
arch runs long_500k (DESIGN.md §Arch-applicability).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32_000,
    sliding_window=4096,
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
)

SMOKE = CONFIG.replace(
    name="h2o-danube-1.8b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, sliding_window=16,
)
