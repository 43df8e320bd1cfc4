"""smollm-135m — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM-135M].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152. The 9-head
attention does not divide a 16-way model axis — the divisibility-aware
sharding rules fall back per-tensor (DESIGN.md §4).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49_152,
    norm="rmsnorm",
    act="swiglu",
    pos="rope",
)

SMOKE = CONFIG.replace(
    name="smollm-135m-smoke",
    n_layers=2, d_model=72, n_heads=3, n_kv_heads=1, head_dim=24,
    d_ff=144, vocab=256,
)
