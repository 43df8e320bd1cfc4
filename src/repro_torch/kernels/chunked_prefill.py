"""Fused chunked-prefill attention over the paged KV pool.

Port of the JAX package's ``kernels/chunked_prefill.py::
chunked_prefill_attention``. The engine prefills a request in slabs
that share each iteration's token budget with decode. The caller
scatters a slab's K/V into the sequence's pages *first*; this kernel
then attends the query slab against every resident page — the prefix
pages matched in the radix tree, earlier chunks and the slab itself —
with query-offset causal masking:

* query position ``i`` of the slab sits at ``q_offsets[b] + i``;
* key ``j`` of page ``p`` sits at ``p * page_size + j``;
* a score survives iff ``k_pos <= q_pos`` and both lie inside
  ``kv_lens[b]``; rows past ``kv_lens`` come out as zeros.

On a CUDA tensor the wrapper launches ``csrc/chunked_prefill.cu`` or
raises; on a CPU tensor it runs the plain version
(``ref.chunked_prefill_attention_ref``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from ._build import aligned16
from .paged_attention import _DTYPES, check_operands

#: kernel launches on CUDA tensors (never counts the plain version)
launches = 0


def chunked_prefill_attention(
    q: torch.Tensor,            # [B, chunk, H, D] query slab
    k_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    v_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    page_table: torch.Tensor,   # [B, pages_per_seq] int32
    q_offsets: torch.Tensor,    # [B] int32 absolute position of q[:, 0]
    kv_lens: torch.Tensor,      # [B] int32 resident tokens incl. this slab
    *,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Attend a prefill slab against the paged KV it was just scattered
    into; out [B, chunk, H, D] in q's dtype, float32 accumulation."""
    B, chunk, H, D = q.shape
    n_pages, page_size, Hk, _ = k_pages.shape
    pages_per_seq = page_table.shape[1]
    if H % Hk:
        raise ValueError(f"{H} query heads do not group over {Hk} kv heads")
    if q.device.type == "cpu":
        return ref.chunked_prefill_attention_ref(
            q, k_pages, v_pages, page_table, q_offsets, kv_lens,
            logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_operands(q, k_pages, v_pages, page_table, q_offsets, kv_lens)
    if (page_table.shape[0] != B or q_offsets.shape != (B,)
            or kv_lens.shape != (B,)):
        raise ValueError("page_table must be [B, P], q_offsets/kv_lens [B]")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("page pools must start on 16 bytes")
    q = aligned16(q.contiguous())
    page_table = page_table.to(torch.int32).contiguous()
    q_offsets = q_offsets.to(torch.int32).contiguous()
    kv_lens = kv_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0 or chunk == 0:
        return out
    fn = _build.load("chunked_prefill", "chunked_prefill_launch")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), q_offsets.data_ptr(), kv_lens.data_ptr(),
             out.data_ptr(), B, chunk, H, Hk, D, page_size, pages_per_seq,
             D ** -0.5, 0.0 if logit_softcap is None else float(logit_softcap),
             _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "chunked_prefill_attention")
    global launches
    launches += 1
    return out
