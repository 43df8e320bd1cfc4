"""Public kernel ops with device dispatch.

The models call these — never the kernels or refs directly. Dispatch
(``impl``):

* ``'auto'`` (default): the CUDA kernel for CUDA tensors, the plain
  PyTorch version for CPU tensors. Nothing else: a CUDA tensor reaches
  the kernel or the call raises.
* ``'cuda'``: the kernel; raises for a tensor that is not on CUDA.
* ``'reference'``: the plain version on any device (the oracle the
  kernels are held against on the card).
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

Impl = str  # 'auto' | 'cuda' | 'reference'
IMPLS = ("auto", "cuda", "reference")


def _use_kernel(impl: Impl, x: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {x.device}")
    return impl != "reference"


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
    the prefill path's flash attention (see
    ``flash_attention.flash_attention``)."""
    if _use_kernel(impl, q):
        return _flash_cuda(q, k, v, causal=causal, window=window,
                           logit_softcap=logit_softcap, prefix_len=prefix_len)
    return ref.flash_attention_chunked(
        q, k, v, causal=causal, window=window, logit_softcap=logit_softcap,
        prefix_len=prefix_len)


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
