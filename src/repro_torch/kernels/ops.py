"""Public kernel ops with device dispatch.

The models call these — never the kernels or refs directly. Dispatch
(``impl``):

* ``'auto'`` (default): the CUDA kernel for CUDA tensors, the plain
  PyTorch version for a tensor on any other device (the CPU, or
  ``meta`` for the dry run's shape-only pass). A CUDA tensor reaches
  the kernel or the call raises.
* ``'cuda'``: the kernel; raises for a tensor that is not on CUDA.
* ``'reference'``: the plain version on any device (the oracle the
  kernels are held against on the card).

The kernels have no backward. On the training path (``attention``,
``ssd``) a CUDA tensor goes through a ``torch.autograd.Function`` whose
forward launches the kernel and whose backward differentiates the plain
version, recomputed from the saved inputs (the JAX package has no
backward kernel either: autodiff runs through its plain forms). Other
tensors take the plain version, which autograd differentiates itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .chunked_prefill import chunked_prefill_attention as _chunked_prefill_cuda
from .flash_attention import flash_attention as _flash_cuda
from .paged_attention import (
    batched_paged_decode_attention as _batched_paged_cuda,
    paged_decode_attention as _paged_cuda,
)
from .ssd_scan import ssd_scan as _ssd_cuda

Impl = str  # 'auto' | 'cuda' | 'reference'
IMPLS = ("auto", "cuda", "reference")
# profiler ranges around the SSD kernel and its plain backward (a
# profile's device time under each name is what they launched)
SSD_FORWARD = "ssd_scan.forward"
SSD_BACKWARD = "ssd_scan.backward_plain"


def _use_kernel(impl: Impl, x: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {x.device}")
    return impl == "cuda" or (impl == "auto" and x.device.type == "cuda")


def _grad_of_plain(plain, inputs, needs, grad_out):
    """Gradients of ``plain(*inputs)`` for the inputs in ``needs``,
    recomputed on detached copies: the backward of a kernel's forward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = plain(*leaves)
        wanted = [t for t, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(got) if n else None for n in needs)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash kernel (B4). Backward: autograd of
    ``ref.flash_attention_chunked`` on the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap, prefix_len):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window,
                      logit_softcap=logit_softcap, prefix_len=prefix_len)
        return _flash_cuda(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, grad_out):
        grads = _grad_of_plain(
            lambda q, k, v: ref.flash_attention_chunked(q, k, v, **ctx.kw),
            ctx.saved_tensors, ctx.needs_input_grad[:3], grad_out)
        return (*grads, None, None, None, None)


class _SSDScan(torch.autograd.Function):
    """Forward: the SSD scan kernel (B5). Backward: autograd of
    ``ref.ssd_chunked`` on the saved x, a, b, c."""

    @staticmethod
    def forward(ctx, x, a, b, c, chunk):
        ctx.save_for_backward(x, a, b, c)
        ctx.chunk = chunk
        with torch.profiler.record_function(SSD_FORWARD):
            return _ssd_cuda(x, a, b, c, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_out):
        with torch.profiler.record_function(SSD_BACKWARD):
            grads = _grad_of_plain(
                lambda x, a, b, c: ref.ssd_chunked(x, a, b, c, chunk=ctx.chunk),
                ctx.saved_tensors, ctx.needs_input_grad[:4], grad_out)
        return (*grads, None)


def attention(
    q: torch.Tensor,            # [B, Lq, H, D]
    k: torch.Tensor,            # [B, Lk, Hk, D]
    v: torch.Tensor,            # [B, Lk, Hk, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    prefix_len: int = 0,
    impl: Impl = "auto",
) -> torch.Tensor:
    """Batched GQA attention, queries aligned to the end of the keys:
    the prefill and training paths' flash attention (see
    ``flash_attention.flash_attention``); differentiable."""
    if _use_kernel(impl, q):
        return _FlashAttention.apply(q, k, v, causal, window, logit_softcap,
                                     prefix_len)
    return ref.flash_attention_chunked(
        q, k, v, causal=causal, window=window, logit_softcap=logit_softcap,
        prefix_len=prefix_len)


def ssd(
    x: torch.Tensor,            # [B, L, H, P] dt-scaled
    a: torch.Tensor,            # [B, L, H]    log decays
    b: torch.Tensor,            # [B, L, G, N]
    c: torch.Tensor,            # [B, L, G, N]
    *,
    chunk: int = 256,
    impl: Impl = "auto",
) -> torch.Tensor:
    """Mamba-2 SSD chunked scan (see ``ssd_scan.ssd_scan``);
    differentiable."""
    if _use_kernel(impl, x):
        return _SSDScan.apply(x, a, b, c, chunk)
    return ref.ssd_chunked(x, a, b, c, chunk=chunk)


def decode_attention(
    q: torch.Tensor,            # [B, H, D]
    k_cache: torch.Tensor,      # [B, S, Hk, D]
    v_cache: torch.Tensor,      # [B, S, Hk, D]
    cache_len: torch.Tensor,    # [B] int
    *,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode against a contiguous per-sequence cache.
    Plain PyTorch on every device: the JAX package has no Pallas kernel
    for it either (a memory-bound gather and GEMV)."""
    return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    window=window,
                                    logit_softcap=logit_softcap)


def paged_decode_attention(
    q: torch.Tensor,            # [B, H, D]
    k_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    v_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    page_table: torch.Tensor,   # [B, pages_per_seq] int32
    seq_lens: torch.Tensor,     # [B] int32
    *,
    logit_softcap: Optional[float] = None,
    impl: Impl = "auto",
) -> torch.Tensor:
    """Per-sequence decode attention over the paged KV pool (see
    ``paged_attention.paged_decode_attention``)."""
    if _use_kernel(impl, q):
        return _paged_cuda(q, k_pages, v_pages, page_table, seq_lens,
                           logit_softcap=logit_softcap)
    return ref.paged_decode_attention_ref(
        q, k_pages, v_pages, page_table, seq_lens,
        logit_softcap=logit_softcap)


def batched_paged_decode_attention(
    q: torch.Tensor,            # [B, H, D]
    k_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    v_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    page_table: torch.Tensor,   # [B, pages_per_seq] int32
    seq_lens: torch.Tensor,     # [B] int32 tokens resident BEFORE this step
    k_new: torch.Tensor,        # [B, Hk, D] this iteration's key (not in pool)
    v_new: torch.Tensor,        # [B, Hk, D]
    *,
    max_pages: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    impl: Impl = "auto",
) -> torch.Tensor:
    """One engine iteration's whole decode set in a single call: paged
    decode with the current token's K/V fused as a trailing virtual
    token (see ``paged_attention.batched_paged_decode_attention``)."""
    # the fused new-token K/V must see pool dtype so results are
    # bit-consistent with scatter-then-read on every impl
    k_new = k_new.to(k_pages.dtype)
    v_new = v_new.to(v_pages.dtype)
    if _use_kernel(impl, q):
        return _batched_paged_cuda(
            q, k_pages, v_pages, page_table, seq_lens, k_new, v_new,
            max_pages=max_pages, logit_softcap=logit_softcap)
    # max_pages is a loop-bound hint; the gather oracle reads every page
    return ref.batched_paged_decode_attention_ref(
        q, k_pages, v_pages, page_table, seq_lens, k_new, v_new,
        logit_softcap=logit_softcap)


def chunked_prefill_attention(
    q: torch.Tensor,            # [B, chunk, H, D] query slab
    k_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    v_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    page_table: torch.Tensor,   # [B, pages_per_seq] int32
    q_offsets: torch.Tensor,    # [B] int32 absolute position of q[:, 0]
    kv_lens: torch.Tensor,      # [B] int32 resident tokens incl. this slab
    *,
    logit_softcap: Optional[float] = None,
    impl: Impl = "auto",
) -> torch.Tensor:
    """Fused chunked-prefill attention over the paged KV pool: one
    prefill slab vs every resident page (cached prefix + prior chunks +
    itself), query-offset causal masked."""
    if _use_kernel(impl, q):
        return _chunked_prefill_cuda(
            q, k_pages, v_pages, page_table, q_offsets, kv_lens,
            logit_softcap=logit_softcap)
    return ref.chunked_prefill_attention_ref(
        q, k_pages, v_pages, page_table, q_offsets, kv_lens,
        logit_softcap=logit_softcap)


def ssm_decode_step(h: torch.Tensor, x_t: torch.Tensor, a_t: torch.Tensor,
                    b_t: torch.Tensor, c_t: torch.Tensor):
    """Single-token SSM state update (the Mamba-2 decode step): (y, the
    new float32 state). Plain PyTorch on every device, as the JAX
    package's ``ops.ssm_decode_step`` calls its plain form on every
    backend: no TPU kernel computes it."""
    return ref.ssm_decode_step_ref(h, x_t, a_t, b_t, c_t)
