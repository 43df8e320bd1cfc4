"""whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356].

32L d_model=1280 20H (MHA: kv=20) d_ff=5120 vocab=51866; 32 encoder
layers over 1500 post-conv audio frames. The conv frontend is a STUB
(``input_specs`` provides precomputed frame embeddings). LayerNorm,
GELU, sinusoidal positions, tied embeddings — whisper flavour.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,              # decoder depth
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51_866,
    enc_seq=1500,
    norm="layernorm",
    act="gelu",
    pos="sinusoidal",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="whisper-large-v3-smoke",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=256, enc_seq=16,
)
