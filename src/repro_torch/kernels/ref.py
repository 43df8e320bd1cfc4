"""Plain PyTorch versions of the attention kernels.

Each function is the semantic ground truth its CUDA kernel is held
against, ported from the JAX package's ``kernels/ref.py``: dense GQA
attention (``mha_naive``, ``flash_attention_chunked``), contiguous-cache
decode, and the paged forms, which gather each sequence's pages into a
contiguous view and then run textbook masked softmax attention in
float32. Rows whose mask is empty have zero mass and come out as zeros
(``l == 0 -> 1``), except in ``mha_naive``, which keeps the textbook
softmax's NaN there as the JAX oracle does. The wrappers in
``flash_attention.py``, ``paged_attention.py`` and
``chunked_prefill.py`` run these for tensors that lie on the CPU.

Page-table entries past a sequence's last page are allocator garbage.
The gathers below clamp every id into the pool, as JAX's gather does
for the JAX oracles; the masked positions never reach the result.
"""

from __future__ import annotations

from typing import Optional

import torch


def _gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """[n_pages, page, Hk, D] gathered through [B, P] -> [B, P*page, Hk, D]."""
    B, P = page_table.shape
    _, page_size, Hk, D = pages.shape
    idx = page_table.long().clamp(0, pages.shape[0] - 1)
    return pages[idx].reshape(B, P * page_size, Hk, D)


def _attention_mask(Lq: int, Lk: int, *, causal: bool,
                    window: Optional[int], prefix_len: int,
                    device) -> torch.Tensor:
    """[Lq, Lk] visibility with queries aligned to the end of the keys
    (query i sits at position ``Lk - Lq + i``): causal, sliding window,
    then the first ``prefix_len`` keys OR'd in (prefix-LM)."""
    q_pos = torch.arange(Lq, device=device)[:, None] + (Lk - Lq)
    k_pos = torch.arange(Lk, device=device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    if prefix_len:
        mask |= k_pos < prefix_len
    return mask


def mha_naive(
    q: torch.Tensor,            # [B, Lq, H, D]
    k: torch.Tensor,            # [B, Lk, Hk, D]
    v: torch.Tensor,            # [B, Lk, Hk, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Textbook GQA attention, materialising the full score matrix.
    Softcap before the mask; a row with no visible key is NaN (plain
    softmax over all ``-inf``), as in the JAX oracle."""
    B, Lq, H, D = q.shape
    Lk, Hk = k.shape[1], k.shape[2]
    group = H // Hk
    qf = q.float() * (D ** -0.5)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    mask = _attention_mask(Lq, Lk, causal=causal, window=window,
                           prefix_len=prefix_len, device=q.device)
    s = s.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vf)
    return out.to(q.dtype)


def flash_attention_chunked(
    q: torch.Tensor,            # [B, Lq, H, D]
    k: torch.Tensor,            # [B, Lk, Hk, D]
    v: torch.Tensor,            # [B, Lk, Hk, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    prefix_len: int = 0,
    block_kv: int = 512,
) -> torch.Tensor:
    """Online-softmax GQA attention over ``block_kv``-key blocks, in
    float32: the plain version of the flash kernel. Same mask as
    :func:`mha_naive`; rows with no visible key come out as zeros."""
    B, Lq, H, D = q.shape
    Lk, Hk = k.shape[1], k.shape[2]
    group = H // Hk
    dev = q.device
    qf = (q.float() * (D ** -0.5)).reshape(B, Lq, Hk, group, D)
    mask = _attention_mask(Lq, Lk, causal=causal, window=window,
                           prefix_len=prefix_len, device=dev)
    m = torch.full((B, Hk, group, Lq), float("-inf"), device=dev)
    l = torch.zeros((B, Hk, group, Lq), device=dev)
    acc = torch.zeros((B, Hk, group, Lq, D), device=dev)
    for j in range(0, Lk, block_kv):
        kb = k[:, j:j + block_kv].float()
        vb = v[:, j:j + block_kv].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb)
        if logit_softcap is not None:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        mb = mask[:, j:j + block_kv]
        s = s.masked_fill(~mb, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully-masked rows so far keep m_new = -inf: guard the exps
        safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(s - safe[..., None]).masked_fill(~mb, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Lq, H, D).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,            # [B, H, D]       one new token per sequence
    k_cache: torch.Tensor,      # [B, S, Hk, D]
    v_cache: torch.Tensor,      # [B, S, Hk, D]
    cache_len: torch.Tensor,    # [B] int         valid prefix length per seq
    *,
    logit_softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode attention against a contiguous KV cache: slot
    ``s`` is visible iff ``s < cache_len`` and, with ``window``,
    ``s >= cache_len - window``."""
    B, S, Hk, D = k_cache.shape
    H = q.shape[1]
    group = H // Hk
    qf = (q.float() * (D ** -0.5)).reshape(B, Hk, group, D)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    n = cache_len.to(q.device).long()[:, None]
    mask = pos < n                                            # [B, S]
    if window is not None:
        mask &= pos >= n - window
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = e.sum(dim=-1, keepdim=True)
    p = e / torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention_ref(
    q: torch.Tensor,            # [B, H, D]
    k_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    v_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    page_table: torch.Tensor,   # [B, pages_per_seq] int32
    seq_lens: torch.Tensor,     # [B] int32
    *,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the per-sequence paged decode kernel: gather the
    pages into a contiguous view and attend over ``seq_lens`` tokens (a
    sequence of length 0 gives zeros)."""
    return decode_attention_ref(
        q, _gather_pages(k_pages, page_table),
        _gather_pages(v_pages, page_table), seq_lens,
        logit_softcap=logit_softcap)


def batched_paged_decode_attention_ref(
    q: torch.Tensor,            # [B, H, D]
    k_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    v_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    page_table: torch.Tensor,   # [B, pages_per_seq] int32
    seq_lens: torch.Tensor,     # [B] int32 tokens resident BEFORE this step
    k_new: torch.Tensor,        # [B, Hk, D]
    v_new: torch.Tensor,        # [B, Hk, D]
    *,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the batched decode kernel: place the new token
    in the gathered contiguous view at position ``seq_lens[b]``, then
    attend over ``seq_lens + 1`` tokens."""
    B = q.shape[0]
    k = _gather_pages(k_pages, page_table)
    v = _gather_pages(v_pages, page_table)
    lens = seq_lens.to(q.device).long()
    # one spare slot so a sequence filling its whole table still has
    # room for its new token (JAX's scatter drops it there instead)
    pad = k.new_zeros((B, 1) + k.shape[2:])
    k = torch.cat([k, pad], dim=1)
    v = torch.cat([v, pad], dim=1)
    rows = torch.arange(B, device=q.device)
    k[rows, lens] = k_new.to(k.dtype)
    v[rows, lens] = v_new.to(v.dtype)
    return decode_attention_ref(q, k, v, lens + 1, logit_softcap=logit_softcap)


def chunked_prefill_attention_ref(
    q: torch.Tensor,            # [B, chunk, H, D] query slab
    k_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    v_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    page_table: torch.Tensor,   # [B, pages_per_seq] int32
    q_offsets: torch.Tensor,    # [B] int32 absolute position of q[:, 0]
    kv_lens: torch.Tensor,      # [B] int32 resident tokens incl. this slab
    *,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the fused chunked-prefill kernel: gather each
    sequence's pages into a contiguous view and apply query-offset causal
    masking at absolute positions (query row i sits at position
    ``q_offsets[b] + i``; rows past ``kv_lens`` come back as zeros)."""
    B, chunk, H, D = q.shape
    Hk = k_pages.shape[2]
    group = H // Hk
    k = _gather_pages(k_pages, page_table).float()
    v = _gather_pages(v_pages, page_table).float()
    S = k.shape[1]
    dev = q.device
    qf = (q.float() * (D ** -0.5)).reshape(B, chunk, Hk, group, D)
    s = torch.einsum("bqhgd,bshd->bhgqs", qf, k)            # [B,Hk,g,chunk,S]
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    q_pos = q_offsets.to(dev).long()[:, None] + torch.arange(chunk, device=dev)
    k_pos = torch.arange(S, device=dev)[None, :]
    kv = kv_lens.to(dev).long()[:, None, None]
    mask = k_pos[:, None, :] <= q_pos[:, :, None]            # causal
    mask &= k_pos[:, None, :] < kv
    mask &= q_pos[:, :, None] < kv
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    # safe softmax: fully-masked rows (q_pos >= kv_len) -> zeros
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = e.sum(dim=-1, keepdim=True)
    p = e / torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhgqs,bshd->bqhgd", p, v)
    return out.reshape(B, chunk, H, D).to(q.dtype)
