"""Decode attention on the CUDA split decode body: the paged batched
form (one engine iteration's whole decode set in a single kernel
launch), the paged per-sequence form, and the slot ring's contiguous
form.

Port of the JAX package's ``kernels/paged_attention.py::
batched_paged_decode_attention``. Each sequence's one new token attends
the shared page pool through its page table, with the token's own K/V
(``k_new``/``v_new``, not yet in the pool) folded in as one more key;
so the kernel never reads a page that the same-step scatter writes, and
the caller scatters after the call. ``max_pages`` bounds the page loop
to the deepest live sequence; it is a hint that never changes results
when it covers every live sequence, as the engine's does.

:func:`paged_decode_attention` ports ``paged_decode_attention``: the
same body without the fused token and without the trim, attending the
``seq_lens`` resident tokens over every page they fill. No model path
calls it; it is held against its plain version on the card.

:func:`slot_decode_attention` is the slot-ring engine's decode
attention (``ops.decode_attention``; the JAX package has no kernel for
it): one token per lane attends its ``cache_len`` entries of a
contiguous ``[B, S, Hk, D]`` cache, read in place through its strides
(a layer's view of the ``[L, B, S, Hk, D]`` cache), trimmed to each
lane's length on the device. :func:`slot_plan` plans it from the shapes
alone, as :func:`split_plan` with pages of one token.

All three launch the split-page body of ``csrc/paged_decode.cu``
(flash-decoding): :func:`split_plan` cuts the page axis into ``S`` runs
of whole pages, one block per (sequence, kv head, run), so a small
batch still fills the card; each block writes a float32 partial
softmax state to a scratch buffer, and the last block of each (sequence,
kv head) to finish merges them in run order (the same bits on every
call). The plan reads only Python ints, never ``seq_lens`` or the
table, so it costs no synchronisation. ``ref.paged_decode_split_ref``
is the plain version of that arithmetic.

On a CUDA tensor each wrapper launches its entry of
``csrc/paged_decode.cu`` or raises; on a CPU tensor it runs the plain
version (``ref.batched_paged_decode_attention_ref``,
``ref.paged_decode_attention_ref``, ``ref.decode_attention_ref``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build, ref

#: batched-kernel launches on CUDA tensors (never counts the plain version)
launches = 0
#: per-sequence-kernel launches on CUDA tensors
paged_decode_launches = 0
#: slot-ring (contiguous cache) kernel launches on CUDA tensors
slot_decode_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the SMs of an H100, and the blocks per SM a plan aims for: three of
#: the group-3 body's 128-thread blocks (~165 registers a thread) fit an
#: SM at once; more would make a second, partial wave
_SMS = 132
_BLOCKS_PER_SM = 3
#: the fewest tokens a split takes: shorter ones leave lanes idle and
#: add partials to merge
_MIN_SPLIT_TOKENS = 32
#: per (device, stream): int32 merge counters, zeroed once and left
#: zeroed by every launch
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def split_plan(B: int, Hk: int, n_page_steps: int, page_size: int
               ) -> Tuple[int, int]:
    """``(pages_per_split, S)``: the page axis ``[0, n_page_steps)`` cut
    into ``S`` runs of ``pages_per_split`` whole pages (the last may be
    shorter), ``S`` chosen so ``B * Hk * S`` blocks are at most about
    ``_BLOCKS_PER_SM`` per SM, with at least ``_MIN_SPLIT_TOKENS`` tokens
    per run. Python ints only: never reads the lengths or the table."""
    if n_page_steps < 1:
        raise ValueError(f"n_page_steps must be >= 1, got {n_page_steps}")
    want = -(-_BLOCKS_PER_SM * _SMS // max(1, B * Hk))
    per = max(-(-n_page_steps // want), -(-_MIN_SPLIT_TOKENS // page_size))
    per = min(per, n_page_steps)
    return per, -(-n_page_steps // per)


def slot_plan(B: int, Hk: int, S: int) -> Tuple[int, int]:
    """``(tokens_per_split, n_splits)`` of the slot kernel: a lane's
    ``S`` slots cut as :func:`split_plan` cuts a page axis of one-token
    pages. Python ints only: never reads the lengths."""
    return split_plan(B, Hk, S, 1)


def _launch_buffers(q: torch.Tensor, S: int, stream: int
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """This launch's float32 partials (``B * H * S * (D + 2)`` values)
    and the stream's merge counters (at least ``B * H``, zeroed); both
    None when ``S`` is 1 (the kernel writes out directly). The caller
    holds the partials until the launch is queued."""
    if S == 1:
        return None, None
    B, H, D = q.shape
    partials = torch.empty(B * H * S * (D + 2), dtype=torch.float32,
                           device=q.device)
    key = (q.device.index, stream)
    tickets = _tickets.get(key)
    if tickets is None or tickets.numel() < B * H:
        tickets = torch.zeros(max(B * H, 256), dtype=torch.int32,
                              device=q.device)
        _tickets[key] = tickets
    return partials, tickets


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check_types(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 *others: torch.Tensor) -> None:
    """Devices, dtypes, head size and K/V shapes the kernels take."""
    D = q.shape[-1]
    for t in (k, v) + others:
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K/V dtype {k.dtype}/{v.dtype} "
                        f"differs from q dtype {q.dtype}")
    if D % 8 or D > 256:
        raise ValueError(f"head_dim must be a multiple of 8 and <= 256, got {D}")
    if k.shape != v.shape or k.shape[-1] != D:
        raise ValueError(f"K/V shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match head_dim {D}")


def check_operands(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, *others: torch.Tensor) -> None:
    """Devices, shapes and types the paged kernels take; raises on
    anything else."""
    _check_types(q, k_pages, v_pages, *others)
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("page pools must start on 16 bytes: the kernels "
                         "load rows 16 bytes at a time")


def check_slot_operands(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, cache_len: torch.Tensor
                        ) -> None:
    """What the slot kernel takes: :func:`check_operands`' types, and
    caches read in place through their lane and token strides, so each
    ``(Hk, D)`` block must be contiguous, K and V must share strides,
    and every row must start on 16 bytes; raises on anything else."""
    _check_types(q, k_cache, v_cache, cache_len)
    B, S, Hk, D = k_cache.shape
    if q.shape[0] != B or cache_len.shape != (B,):
        raise ValueError(f"q {tuple(q.shape)}, cache_len "
                         f"{tuple(cache_len.shape)} and cache "
                         f"{tuple(k_cache.shape)} differ in lanes")
    if k_cache.stride() != v_cache.stride():
        raise ValueError(f"K/V strides {k_cache.stride()} and "
                         f"{v_cache.stride()} differ")
    b_stride, s_stride, h_stride, d_stride = k_cache.stride()
    if d_stride != 1 or (Hk > 1 and h_stride != D):
        raise ValueError(f"each cache row (Hk, D) must be contiguous, "
                         f"strides {k_cache.stride()}")
    e = k_cache.element_size()
    if (k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16
            or (b_stride * e) % 16 or (s_stride * e) % 16):
        raise ValueError("cache rows must start on 16 bytes: the kernel "
                         "loads rows 16 bytes at a time")


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
) -> torch.Tensor:
    """Attention of ``seq_lens + 1`` tokens per sequence; out [B, H, D]
    in q's dtype, float32 accumulation."""
    B, H, D = q.shape
    n_pages, page_size, Hk, _ = k_pages.shape
    pages_per_seq = page_table.shape[1]
    n_page_steps = pages_per_seq if max_pages is None else max_pages
    if not 1 <= n_page_steps <= pages_per_seq:
        raise ValueError(f"max_pages {max_pages} outside [1, {pages_per_seq}]")
    if H % Hk:
        raise ValueError(f"{H} query heads do not group over {Hk} kv heads")
    if q.device.type == "cpu":
        return ref.batched_paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, seq_lens, k_new, v_new,
            logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_operands(q, k_pages, v_pages, page_table, seq_lens, k_new, v_new)
    if (k_new.shape != (B, Hk, D) or v_new.shape != (B, Hk, D)
            or page_table.shape[0] != B or seq_lens.shape != (B,)):
        raise ValueError("k_new/v_new must be [B, Hk, D], page_table [B, P], "
                         "seq_lens [B]")
    q = _build.aligned16(q.contiguous())
    k_new = _build.aligned16(k_new.to(q.dtype).contiguous())
    v_new = _build.aligned16(v_new.to(q.dtype).contiguous())
    page_table = page_table.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    per, S = split_plan(B, Hk, n_page_steps, page_size)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    partials, tickets = _launch_buffers(q, S, stream)
    fn = _build.load("paged_decode", "batched_paged_decode_launch")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), k_new.data_ptr(),
             v_new.data_ptr(), out.data_ptr(), _ptr(partials), _ptr(tickets),
             B, H, Hk, D, page_size, pages_per_seq, n_page_steps, per, S,
             D ** -0.5,
             0.0 if logit_softcap is None else float(logit_softcap),
             _DTYPES[q.dtype], stream)
    _build.check(err, "batched_paged_decode_attention")
    global launches
    launches += 1
    return out


def paged_decode_attention(
    q: torch.Tensor,            # [B, H, D]
    k_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    v_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    page_table: torch.Tensor,   # [B, pages_per_seq] int32
    seq_lens: torch.Tensor,     # [B] int32 resident tokens
    *,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Attention of the ``seq_lens`` resident tokens per sequence; out
    [B, H, D] in q's dtype, float32 accumulation, zeros where
    ``seq_lens`` is 0. Table entries past ``ceil(seq_len / page)`` are
    never read."""
    B, H, D = q.shape
    n_pages, page_size, Hk, _ = k_pages.shape
    pages_per_seq = page_table.shape[1]
    if H % Hk:
        raise ValueError(f"{H} query heads do not group over {Hk} kv heads")
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, seq_lens,
            logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_operands(q, k_pages, v_pages, page_table, seq_lens)
    if page_table.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("page_table must be [B, P], seq_lens [B]")
    q = _build.aligned16(q.contiguous())
    page_table = page_table.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    per, S = split_plan(B, Hk, pages_per_seq, page_size)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    partials, tickets = _launch_buffers(q, S, stream)
    fn = _build.load("paged_decode", "paged_decode_launch")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
             _ptr(partials), _ptr(tickets), B, H, Hk, D, page_size,
             pages_per_seq, per, S, D ** -0.5,
             0.0 if logit_softcap is None else float(logit_softcap),
             _DTYPES[q.dtype], stream)
    _build.check(err, "paged_decode_attention")
    global paged_decode_launches
    paged_decode_launches += 1
    return out


def slot_decode_attention(
    q: torch.Tensor,            # [B, H, D]
    k_cache: torch.Tensor,      # [B, S, Hk, D], rows read in place
    v_cache: torch.Tensor,      # [B, S, Hk, D]
    cache_len: torch.Tensor,    # [B] int valid entries per lane
    *,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Attention of each lane's token over its cache entries ``s <
    cache_len``: out [B, H, D] in q's dtype, float32 accumulation, zeros
    where ``cache_len`` is 0. No window: a ring holds only the positions
    inside a model's window. Reads no length on the host."""
    B, H, D = q.shape
    _, S, Hk, _ = k_cache.shape
    if H % Hk:
        raise ValueError(f"{H} query heads do not group over {Hk} kv heads")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                        logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_slot_operands(q, k_cache, v_cache, cache_len)
    q = _build.aligned16(q.contiguous())
    cache_len = cache_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    per, n_splits = slot_plan(B, Hk, S)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    partials, tickets = _launch_buffers(q, n_splits, stream)
    b_stride, s_stride = k_cache.stride(0), k_cache.stride(1)
    fn = _build.load("paged_decode", "slot_decode_launch")
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             cache_len.data_ptr(), out.data_ptr(), _ptr(partials),
             _ptr(tickets), B, H, Hk, D, S, per, n_splits, b_stride,
             s_stride, D ** -0.5,
             0.0 if logit_softcap is None else float(logit_softcap),
             _DTYPES[q.dtype], stream)
    _build.check(err, "slot_decode_attention")
    global slot_decode_launches
    slot_decode_launches += 1
    return out
