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

On a mesh (``distributed/sharding.py``) the training path's inputs are
DTensors: ``attention`` and ``ssd`` take them through ``local_map``
before any device dispatch, so the kernel (or, on the CPU and ``meta``,
its plain version) sees each rank's local tensors only -- its batch
rows and its heads, whole sequences -- and the result is a DTensor
again. A kv head (B/C group) shared by q heads (x heads) of several
ranks stays replicated and each rank takes the ones its heads read.

The kernels have no backward. On the training path (``attention``,
``ssd``) a CUDA tensor goes through a ``torch.autograd.Function`` whose
forward launches the kernel and whose backward differentiates the plain
version, recomputed from the saved inputs (the JAX package has no
backward kernel either: autodiff runs through its plain forms). Other
tensors take the plain version, which autograd differentiates itself.

With a live process-global recorder (``obs.get_recorder()``, read at
each call: the models take no recorder) ``attention``,
``decode_attention``, ``ssd_with_state`` and ``ssm_decode_step`` each
record an ``ops.*`` span of the call, ``attention``'s with its shape
(on a mesh only ``attention`` does, around each rank's local call).
With the recorder off each costs one call that returns the shared
no-op span (``attention`` checks ``enabled`` first).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..obs import get_recorder
from ..obs import events as tr
from . import ref
from .chunked_prefill import chunked_prefill_attention as _chunked_prefill_cuda
from .flash_attention import flash_attention as _flash_cuda
from .paged_attention import (
    batched_paged_decode_attention as _batched_paged_cuda,
    paged_decode_attention as _paged_cuda,
    slot_decode_attention as _slot_decode_cuda,
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


def _head_plan(x: DTensor, head_dim: int, n_groups: int
               ) -> Tuple[list, list, list, list]:
    """Placements of a head-sharded call on ``x``'s mesh: (``x``'s,
    keeping its Shard of dim 0 and of ``head_dim`` and replicating the
    rest; the grouped operands' (kv heads or B/C groups, ``n_groups`` of
    them, on the same dim), sharded with the heads when ``n_groups``
    splits as evenly, else replicated; the grouped operands' gradient
    placements, ``Partial`` where they are replicated over a head-split
    mesh dim; the mesh dims that split the heads)."""
    mesh = x.device_mesh
    x_pl, split = [], []
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim in (0, head_dim):
            x_pl.append(pl)
            split += [i] if pl.dim == head_dim else []
        else:
            x_pl.append(Replicate())
    n = math.prod(mesh.size(i) for i in split)
    even = n_groups % n == 0
    g_pl = [Replicate() if i in split and not even else pl
            for i, pl in enumerate(x_pl)]
    g_grad = [Partial() if i in split and not even else pl
              for i, pl in enumerate(x_pl)]
    return x_pl, g_pl, g_grad, split


def _local_groups(mesh, split: Sequence[int], n_heads: int, n_local: int,
                  n_groups: int, grouped: Sequence[torch.Tensor],
                  dim: int) -> list:
    """Each of ``grouped`` (all ``n_groups`` groups on ``dim``) cut to
    the groups of this rank's ``n_local`` heads, heads numbered as the
    mesh dims ``split`` split them. The kernels map local head ``j`` to
    group ``j // (n_local / local groups)``: that holds when the local
    heads fill whole groups or lie inside one; other splits raise."""
    if not split or n_local == n_heads or grouped[0].shape[dim] < n_groups:
        return list(grouped)          # unsplit, or split with the heads
    r = 0
    for i in split:
        r = r * mesh.size(i) + mesh.get_local_rank(i)
    size = n_heads // n_groups                   # heads per group
    h0 = r * n_local
    if not (n_local % size == 0 or size % n_local == 0):
        raise ValueError(f"{n_local} local heads of {n_heads} split the "
                         f"{n_groups} groups unevenly")
    g0, g1 = h0 // size, (h0 + n_local - 1) // size + 1
    return [t.narrow(dim, g0, g1 - g0) for t in grouped]


def _on_mesh(t: torch.Tensor, mesh) -> DTensor:
    """``t`` as a DTensor: a plain tensor (lengths, positions the model
    made) replicated on ``mesh``."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous. A local
    gradient from ``local_map`` keeps the layout the plain backward gave
    it (einsum's permutations), and DTensor then runs the global
    reshapes after it as local ``view`` s, which a permuted tensor
    refuses."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _attention_mesh(q, k, v, kw, impl):
    H, Hk = q.shape[2], k.shape[2]
    mesh = q.device_mesh
    q_pl, kv_pl, kv_grad, split = _head_plan(q, 2, Hk)

    def local(ql, kl, vl):
        ql, kl, vl = (_ContiguousGrad.apply(t) for t in (ql, kl, vl))
        kl, vl = _local_groups(mesh, split, H, ql.shape[2], Hk, (kl, vl), 2)
        return attention(ql, kl, vl, impl=impl, **kw).contiguous()

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        *(_on_mesh(t, mesh) for t in (q, k, v)))


def _ssd_mesh(x, a, b, c, chunk, impl):
    H, G = x.shape[2], b.shape[2]
    mesh = x.device_mesh
    x_pl, g_pl, g_grad, split = _head_plan(x, 2, G)

    def local(xl, al, bl, cl):
        xl, al, bl, cl = (_ContiguousGrad.apply(t) for t in (xl, al, bl, cl))
        bl, cl = _local_groups(mesh, split, H, xl.shape[2], G, (bl, cl), 2)
        return ssd(xl, al, bl, cl, chunk=chunk, impl=impl).contiguous()

    return local_map(local, out_placements=x_pl,
                     in_placements=(x_pl, x_pl, g_pl, g_pl),
                     in_grad_placements=(x_pl, x_pl, g_grad, g_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        *(_on_mesh(t, mesh) for t in (x, a, b, c)))


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
    ``flash_attention.flash_attention``); differentiable. DTensor
    inputs go through ``local_map`` (module doc)."""
    if isinstance(q, DTensor):
        return _attention_mesh(
            q, k, v, dict(causal=causal, window=window,
                          logit_softcap=logit_softcap,
                          prefix_len=prefix_len), impl)
    rec = get_recorder()
    span = rec.span(
        tr.OPS_ATTENTION, B=q.shape[0], Lq=q.shape[1], Lk=k.shape[1],
        H=q.shape[2], Hk=k.shape[2], D=q.shape[3], causal=causal,
        window=window) if rec.enabled else tr.NULL_SPAN
    with span:
        if _use_kernel(impl, q):
            return _FlashAttention.apply(q, k, v, causal, window,
                                         logit_softcap, prefix_len)
        return ref.flash_attention_chunked(
            q, k, v, causal=causal, window=window,
            logit_softcap=logit_softcap, prefix_len=prefix_len)


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
    differentiable. DTensor inputs go through ``local_map`` (module
    doc)."""
    if isinstance(x, DTensor):
        return _ssd_mesh(x, a, b, c, chunk, impl)
    if _use_kernel(impl, x):
        return _SSDScan.apply(x, a, b, c, chunk)
    return ref.ssd_chunked(x, a, b, c, chunk=chunk)


def _decode_attention(q, k_cache, v_cache, cache_len, window,
                      logit_softcap, impl):
    """One device's contiguous-cache decode: the slot kernel or the
    plain version, by ``impl``."""
    if _use_kernel(impl, q):
        if window is not None:
            raise ValueError("the slot kernel takes no window (a ring holds "
                             "only the window's positions): pass "
                             "impl='reference' for a windowed mask")
        return _slot_decode_cuda(q, k_cache, v_cache, cache_len,
                                 logit_softcap=logit_softcap)
    return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    window=window, logit_softcap=logit_softcap)


def decode_attention(
    q: torch.Tensor,            # [B, H, D]
    k_cache: torch.Tensor,      # [B, S, Hk, D]
    v_cache: torch.Tensor,      # [B, S, Hk, D]
    cache_len: torch.Tensor,    # [B] int
    *,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    impl: Impl = "auto",
) -> torch.Tensor:
    """Single-token decode against a contiguous per-sequence cache (the
    slot ring; see ``paged_attention.slot_decode_attention``): the slot
    kernel, which reads each lane's ``cache_len`` entries in place in
    the cache's dtype, for CUDA tensors, the plain float32 version
    otherwise. The JAX package has no kernel here (its plain ``jnp``
    form). The kernel takes no ``window``: a ring holds only the
    positions inside a model's window, so no model path passes one, and
    a window on CUDA tensors needs ``impl='reference'``. On a mesh whose
    cache keeps S whole, each rank attends its batch rows' heads through
    ``local_map`` with the same dispatch on its local tensors, as
    ``attention``. A cache split on S (kv heads that do not divide the
    model axis) has no kernel: the kernel cannot reduce the softmax
    across ranks. There the plain ops run on DTensors, which reduce
    over S across the ranks, only where the caller asks for them
    (``impl='reference'``) or the tensors are not on CUDA; ``auto`` and
    ``cuda`` raise on CUDA tensors."""
    seq_split = isinstance(k_cache, DTensor) and any(
        isinstance(pl, Shard) and pl.dim == 1 for pl in k_cache.placements)
    if isinstance(q, DTensor) and not seq_split:
        H, Hk = q.shape[1], k_cache.shape[2]
        mesh = q.device_mesh
        q_pl, kv_pl, _, split = _head_plan(q, 1, Hk)
        kv_pl = [Shard(2) if pl == Shard(1) else pl for pl in kv_pl]
        len_pl = [pl if pl == Shard(0) else Replicate() for pl in q_pl]

        def local(ql, kl, vl, nl):
            kl, vl = _local_groups(mesh, split, H, ql.shape[1], Hk, (kl, vl), 2)
            return _decode_attention(ql, kl, vl, nl, window, logit_softcap,
                                     impl)

        return local_map(local, out_placements=q_pl,
                         in_placements=(q_pl, kv_pl, kv_pl, len_pl),
                         device_mesh=mesh, redistribute_inputs=True)(
            *(_on_mesh(t, mesh) for t in (q, k_cache, v_cache, cache_len)))
    if seq_split and _use_kernel(impl, q):
        raise ValueError("a cache split on S has no kernel (the slot kernel "
                         "cannot reduce the softmax across ranks): pass "
                         "impl='reference' for the plain DTensor ops")
    with get_recorder().span(tr.OPS_DECODE_ATTENTION):
        return _decode_attention(q, k_cache, v_cache, cache_len, window,
                                 logit_softcap, impl)


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
    backend: no TPU kernel computes it. On a mesh each rank updates its
    batch rows' heads (``local_map``, as ``ssd``)."""
    if isinstance(x_t, DTensor):
        H, G = x_t.shape[1], b_t.shape[1]
        mesh = x_t.device_mesh
        x_pl, g_pl, _, split = _head_plan(x_t, 1, G)

        def local(hl, xl, al, bl, cl):
            bl, cl = _local_groups(mesh, split, H, xl.shape[1], G, (bl, cl), 1)
            return ref.ssm_decode_step_ref(hl, xl, al, bl, cl)

        return local_map(local, out_placements=(x_pl, x_pl),
                         in_placements=(x_pl, x_pl, x_pl, g_pl, g_pl),
                         device_mesh=mesh, redistribute_inputs=True)(
            *(_on_mesh(t, mesh) for t in (h, x_t, a_t, b_t, c_t)))
    with get_recorder().span(tr.OPS_SSM_DECODE_STEP):
        return ref.ssm_decode_step_ref(h, x_t, a_t, b_t, c_t)


def ssd_with_state(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int = 256):
    """The SSD scan and its final state [B, H, P, N] (float32): the
    plain ``ref.ssd_chunked(..., return_final_state=True)`` on every
    device, as the serving prefill runs it (no kernel gives the state:
    ROADMAP B item 6). On a mesh through ``local_map``, as ``ssd``."""
    if isinstance(x, DTensor):
        H, G = x.shape[2], b.shape[2]
        mesh = x.device_mesh
        x_pl, g_pl, _, split = _head_plan(x, 2, G)
        state_pl = [Shard(1) if pl == Shard(2) else pl for pl in x_pl]

        def local(xl, al, bl, cl):
            bl, cl = _local_groups(mesh, split, H, xl.shape[2], G, (bl, cl), 2)
            return ref.ssd_chunked(xl, al, bl, cl, chunk=chunk,
                                   return_final_state=True)

        return local_map(local, out_placements=(x_pl, state_pl),
                         in_placements=(x_pl, x_pl, g_pl, g_pl),
                         device_mesh=mesh, redistribute_inputs=True)(
            *(_on_mesh(t, mesh) for t in (x, a, b, c)))
    with get_recorder().span(tr.OPS_SSD_WITH_STATE):
        return ref.ssd_chunked(x, a, b, c, chunk=chunk,
                               return_final_state=True)
