"""Paged decode attention: the batched form (one engine iteration's
whole decode set in a single kernel launch) and the per-sequence form.

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

Both launch the split-page body of ``csrc/paged_decode.cu``
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
``ref.paged_decode_attention_ref``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build, ref

#: batched-kernel launches on CUDA tensors (never counts the plain version)
launches = 0
#: per-sequence-kernel launches on CUDA tensors
paged_decode_launches = 0

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


def check_operands(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, *others: torch.Tensor) -> None:
    """Devices, shapes and types the CUDA kernels take; raises on
    anything else."""
    D = q.shape[-1]
    for t in (k_pages, v_pages) + others:
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"pool dtype {k_pages.dtype}/{v_pages.dtype} "
                        f"differs from q dtype {q.dtype}")
    if D % 8 or D > 256:
        raise ValueError(f"head_dim must be a multiple of 8 and <= 256, got {D}")
    if k_pages.shape != v_pages.shape or k_pages.shape[-1] != D:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} do not match head_dim {D}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("page pools must start on 16 bytes: the kernels "
                         "load rows 16 bytes at a time")


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
