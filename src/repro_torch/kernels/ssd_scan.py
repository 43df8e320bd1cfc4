"""Mamba-2 SSD chunked scan: the SSM family's sequence mixer.

Port of the JAX package's ``kernels/ssd_scan.py::ssd_scan``. Inputs are
pre-discretised: ``x`` [B, L, H, P] already dt-scaled, ``a`` [B, L, H]
the per-step log decay (<= 0), ``b``/``c`` [B, L, G, N] shared by the
``H // G`` heads of a group. Per (batch, head) the chunks of ``chunk``
tokens run in order with a [P, N] float32 state carried across them:
an intra-chunk decay-masked ``(C B^T o L) X`` term plus the inter-chunk
``C state^T`` term. Any ``L``: the Pallas kernel asserts
``L % chunk == 0``; here, as in ``ref.ssd_chunked``, a short last chunk
is exact and ``chunk > L`` acts as ``chunk = L``.

On a CUDA tensor the wrapper launches ``csrc/ssd_scan.cu`` or raises;
on a CPU tensor it runs the plain version (``ref.ssd_chunked``). The
kernel runs the three stages of ``ref.ssd_chunked_pieces`` (chunk
states, the state pass, the chunk scan) as :func:`cuda_launches` CUDA
launches, with float32 scratch the wrapper allocates
(:func:`scratch_sizes`). The kernel has no backward: ``ops.ssd`` wraps
it in an autograd Function whose backward differentiates the plain
version.
"""

from __future__ import annotations

import torch

from . import _build, ref
from .paged_attention import _DTYPES

#: calls that launched the kernel on CUDA tensors (one per call, however
#: many CUDA launches it takes; never counts the plain version)
launches = 0


def n_chunks(L: int, chunk: int) -> int:
    """Chunks of a sequence of ``L`` tokens (``chunk > L`` acts as L)."""
    return -(-L // max(1, min(chunk, L)))


def scratch_sizes(B: int, L: int, H: int, P: int, N: int,
                  chunk: int) -> dict:
    """float32 elements of the kernel's scratch: ``states``, the carried
    [P, N] state after every chunk but the last, per (batch, head), then
    as many bf16 (the third bf16 part of each, for the tensor-core
    products), and ``lcs``, the cumsum of ``a`` over each
    chunk."""
    Q = max(1, min(chunk, L))
    nc = n_chunks(L, chunk)
    n_states = B * (nc - 1) * H * P * N           # even: P >= 16
    return {"states": n_states + n_states // 2, "lcs": B * nc * H * Q}


def cuda_launches(L: int, chunk: int) -> int:
    """CUDA launches of one kernel call: chunk states, the state pass
    (only with more than one chunk) and the chunk scan."""
    return 3 if n_chunks(L, chunk) > 1 else 2


def ssd_scan(
    x: torch.Tensor,            # [B, L, H, P] dt-scaled inputs
    a: torch.Tensor,            # [B, L, H]    per-step log decay (<= 0)
    b: torch.Tensor,            # [B, L, G, N]
    c: torch.Tensor,            # [B, L, G, N]
    *,
    chunk: int = 256,
) -> torch.Tensor:
    """SSD scan; y [B, L, H, P] in x's dtype, float32 inside."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if a.shape != (B, L, H):
        raise ValueError(f"a {tuple(a.shape)} does not match x {tuple(x.shape)}")
    if b.shape[:2] != (B, L) or c.shape != b.shape:
        raise ValueError(f"b {tuple(b.shape)}, c {tuple(c.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if G < 1 or H % G:
        raise ValueError(f"{H} heads do not group over {G} groups")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, a, b, c, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    for t in (a, b, c):
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"a/b/c dtype {t.dtype} differs from x dtype {x.dtype}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if P not in (16, 32, 64, 128) or N % 4 or not 4 <= N <= 256 \
            or P * N > 8192:
        raise ValueError(f"kernel takes P in (16, 32, 64, 128) and N a multiple "
                         f"of 4 in [4, 256] with P * N <= 8192; got P {P}, N {N}")
    x, a, b, c = (_build.aligned16(t.contiguous()) for t in (x, a, b, c))
    out = torch.empty_like(x)
    if B == 0 or L == 0 or H == 0:
        return out
    sizes = scratch_sizes(B, L, H, P, N, chunk)
    states = torch.empty(sizes["states"], dtype=torch.float32, device=x.device)
    lcs = torch.empty(sizes["lcs"], dtype=torch.float32, device=x.device)
    fn = _build.load("ssd_scan", "ssd_scan_launch")
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
             out.data_ptr(), states.data_ptr(), lcs.data_ptr(), B, L, H, G,
             P, N, min(chunk, L), _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan")
    global launches
    launches += 1
    return out
