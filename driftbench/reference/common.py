"""Plain float32 pieces the reference models share, and the control's
lower precision.

The reference reads the weights that the benchmark drew (bf16, in the
port's leaf layout) and upcasts one layer at a time. With ``fp8`` every
matrix product takes both operands through float8 e4m3 first (weights
scaled per output column, activations per row, as an fp8 serving path
would), and computes in float32: the control of the check that decides
``correct``.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0          # largest finite float8_e4m3fn


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the reduction axis), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def mm(x: torch.Tensor, w: torch.Tensor, low: bool) -> torch.Tensor:
    """``x [.., k] @ w [k, n]`` in float32; with ``low`` in fp8."""
    x, w = x.float(), w.float()
    if low:
        x, w = fp8(x, -1), fp8(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm with the scale stored as its offset from 1 (the port's
    layout of the norm weight)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def unembed(h: torch.Tensor, table: torch.Tensor, low: bool) -> torch.Tensor:
    """Logits ``h [L, d] @ table [V, d]^T``."""
    return mm(h, table.float().T, low)


@contextlib.contextmanager
def full_float32():
    """Float32 products in float32: TF32 off for the reference."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def normal(gen: torch.Generator, shape, std: float,
           dtype: torch.dtype) -> torch.Tensor:
    """One draw of a whole leaf on the generator's device."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).mul_(std).to(dtype)


def uniform(gen: torch.Generator, shape, lo: float,
            hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=gen.device).mul_(hi - lo).add_(lo)
