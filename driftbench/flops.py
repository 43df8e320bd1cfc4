"""The chip's peaks, and the least time of the B4 flash-attention call
from its shapes alone.

A model's FLOPs per token live with its equations, in
``reference/<family>.py`` (``token_flops``, ``prefill_flops``), found
through the configuration's ``reference`` entry: a configuration of a
new family brings its count in its own file.

Peaks: one NVIDIA H100 SXM, dense bf16 989 TFLOP/s and 3.35 TB/s of HBM
(NVIDIA's data sheet, at the 700 W limit; the run prints the card's
power limit beside every share).
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def flash_bound_s(c: Dict, length: int) -> float:
    """Least time of one causal flash-attention call over a ``[1,
    length]`` prefill (the B4 kernel, one call a layer): q, k, v and the
    output read or written once in bf16, 4 FLOPs per (query head,
    visible key, channel), the larger of the two over the peaks."""
    H, Hk, D = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    window = c.get("sliding_window") or length
    n_bytes = 2 * 2 * length * D * (H + Hk)
    pairs = sum(min(j, window) for j in range(1, length + 1)) \
        if window < length else length * (length + 1) // 2
    return max(n_bytes / PEAK_BYTES, 4 * H * D * pairs / PEAK_FLOPS)
