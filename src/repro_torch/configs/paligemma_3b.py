"""paligemma-3b — SigLIP + gemma VLM [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216; gemma-style
head_dim 256, tied embeddings, sqrt(d) embedding scale, GeGLU. The
SigLIP patch frontend is a STUB: 256 precomputed patch embeddings are
prepended as a prefix and attended with prefix-LM masking.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab=257_216,
    prefix_len=256,
    norm="rmsnorm",
    act="geglu",
    pos="rope",
    embed_scale=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="paligemma-3b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=128, vocab=256, prefix_len=8,
)
