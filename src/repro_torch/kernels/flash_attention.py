"""Dense GQA flash attention: the slot-ring engine's prefill attention.

Port of the JAX package's ``kernels/flash_attention.py::
flash_attention``. Queries ``[B, Lq, H, D]`` attend keys and values
``[B, Lk, Hk, D]`` with the queries aligned to the end of the keys
(query ``i`` sits at position ``Lk - Lq + i``, negative for the first
``Lq - Lk`` queries when there are more queries than keys, as in a
decoder bucket longer than the encoder's keys under cross-attention):

* ``causal``: a key is visible iff ``k_pos <= q_pos``;
* ``window``: and ``q_pos - k_pos < window``;
* ``prefix_len``: the first ``prefix_len`` keys are visible to every
  query (prefix-LM, OR'd in after the two above);
* ``logit_softcap`` caps the scores before the mask;
* a row with no visible key comes out as zeros.

On a CUDA tensor the wrapper launches ``csrc/flash_attention.cu`` or
raises; on a CPU tensor it runs the plain version
(``ref.flash_attention_chunked``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from ._build import aligned16
from .paged_attention import _DTYPES

#: kernel launches on CUDA tensors (never counts the plain version)
launches = 0


def flash_attention(
    q: torch.Tensor,            # [B, Lq, H, D]
    k: torch.Tensor,            # [B, Lk, Hk, D]
    v: torch.Tensor,            # [B, Lk, Hk, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    """GQA attention; out [B, Lq, H, D] in q's dtype, float32
    accumulation."""
    B, Lq, H, D = q.shape
    Bk, Lk, Hk, Dk = k.shape
    if H % Hk:
        raise ValueError(f"{H} query heads do not group over {Hk} kv heads")
    if Bk != B or Dk != D or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.device.type == "cpu":
        return ref.flash_attention_chunked(
            q, k, v, causal=causal, window=window,
            logit_softcap=logit_softcap, prefix_len=prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"k/v dtype {t.dtype} differs from q dtype {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if D % 8 or D > 256:
        raise ValueError(f"head_dim must be a multiple of 8 and <= 256, got {D}")
    q, k, v = (aligned16(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    if B == 0 or Lq == 0:
        return out
    fn = _build.load("flash_attention", "flash_attention_launch")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, Lq, Lk, H, Hk, D, int(causal),
             0 if window is None else int(window), int(prefix_len),
             D ** -0.5, 0.0 if logit_softcap is None else float(logit_softcap),
             _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    global launches
    launches += 1
    return out
