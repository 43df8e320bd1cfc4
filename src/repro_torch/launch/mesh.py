"""Hardware constants of the port's roofline (importing this module
touches no device state).

The JAX package's ``launch/mesh.py`` holds a TPU pod's mesh constructors
and the TPU's constants; the port runs on one NVIDIA H100, so this
module holds the H100's ``HW`` under the same keys, which
``launch/analysis.py`` reads.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense rates without
# sparsity, at the card's full 700 W power limit; a card set below it
# runs slower under load): bf16 tensor cores 989 TFLOP/s, HBM3 80 GB at
# 3.35 TB/s, NVLink 4 900 GB/s per GPU, 450 GB/s each way. "ici_bw"
# keeps the JAX key of the collective term's link rate.
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s per card
    "hbm_bw": 3.35e12,           # bytes/s per card
    "ici_bw": 450e9,             # bytes/s each way per card (NVLink 4)
    "hbm_bytes": 80e9,           # 80 GB of HBM3 per card
}
