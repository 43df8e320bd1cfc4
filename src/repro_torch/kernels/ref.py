"""Plain PyTorch versions of the kernels.

Each function is the semantic ground truth its CUDA kernel is held
against, ported from the JAX package's ``kernels/ref.py``: dense GQA
attention (``mha_naive``, ``flash_attention_chunked``), contiguous-cache
decode, the paged forms, which gather each sequence's pages into a
contiguous view and then run textbook masked softmax attention in
float32 (``paged_decode_split_ref`` and ``slot_decode_split_ref``
repeat the split decode kernel's own order: per-run partials merged in
run order), and the
Mamba-2 SSD scan (``ssd_naive``, ``ssd_chunked``) and its one-token
decode step (``ssm_decode_step_ref``, which has no kernel: the JAX
package runs its plain form on every backend). Rows whose mask is
empty have zero mass and come out as zeros (``l == 0 -> 1``), except
in ``mha_naive``, which keeps the textbook softmax's NaN there as the
JAX oracle does. The wrappers in
``flash_attention.py``, ``paged_attention.py``, ``chunked_prefill.py``
and ``ssd_scan.py`` run these for tensors that lie on the CPU.

Page-table entries past a sequence's last page are allocator garbage.
The gathers below clamp every id into the pool, as JAX's gather does
for the JAX oracles; the masked positions never reach the result.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributed import sharding as shd


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
    # on a mesh (a cache split on S: ops.decode_attention) q's heads may
    # be split finer than the kv heads; these views then gather them
    qf = shd.unflatten(q.float() * (D ** -0.5), 1, (Hk, group))
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
    return shd.flatten(out, 1, 2).to(q.dtype)


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


def _merge_split_runs(qf: torch.Tensor, runs, logit_softcap: Optional[float]
                      ) -> torch.Tensor:
    """The split decode kernels' arithmetic on float32 queries ``qf``
    ``[B, Hk, g, D]`` (scaled): each of ``runs``, a (k, v, mask) of
    ``[B, T, Hk, D]`` float32 K/V and its ``[B, T]`` visible keys, gives
    a partial (m, l, acc) (m = -inf, l = 0 where nothing is visible);
    the partials merge in run order. A lane with no mass gives zeros.
    Returns ``[B, Hk, g, D]`` float32."""
    parts = []
    for k, v, mask in runs:
        s = torch.einsum("bhgd,bthd->bhgt", qf, k)
        if logit_softcap is not None:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        s = s.masked_fill(~mask[:, None, None], float("-inf"))
        m = s.amax(dim=-1)                                 # [B, Hk, g]
        safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        e = torch.exp(s - safe[..., None])
        parts.append((m, e.sum(dim=-1),
                      torch.einsum("bhgt,bthd->bhgd", e, v)))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    safe = torch.where(torch.isfinite(m_all), m_all, torch.zeros_like(m_all))
    mass = torch.zeros_like(m_all)
    acc = torch.zeros_like(qf)
    for m, l, a in parts:
        w = torch.exp(m - safe)
        mass = mass + l * w
        acc = acc + a * w[..., None]
    return acc / torch.where(mass == 0.0, torch.ones_like(mass), mass)[..., None]


def paged_decode_split_ref(
    q: torch.Tensor,            # [B, H, D]
    k_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    v_pages: torch.Tensor,      # [n_pages, page_size, Hk, D]
    page_table: torch.Tensor,   # [B, pages_per_seq] int32
    seq_lens: torch.Tensor,     # [B] int32
    k_new: Optional[torch.Tensor] = None,   # [B, Hk, D] fused token
    v_new: Optional[torch.Tensor] = None,
    *,
    pages_per_split: int,
    n_page_steps: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the split-page kernel's arithmetic, in float32:
    the pages ``[0, n_page_steps)`` (default: the whole table) are cut
    into runs of ``pages_per_split``; each run's tokens, up to
    ``min(seq_len, pages attended * page)``, give a partial (m, l, acc)
    (m = -inf, l = 0 for a run past the sequence's end), and the
    partials merge in run order. With ``k_new``/``v_new`` the current
    token joins run 0 as one more key (the batched form); without, a
    ``seq_len`` of 0 gives zeros (the per-sequence form)."""
    B, H, D = q.shape
    page_size, Hk = k_pages.shape[1], k_pages.shape[2]
    pps = page_table.shape[1]
    steps_max = pps if n_page_steps is None else n_page_steps
    group = H // Hk
    dev = q.device
    qf = (q.float() * (D ** -0.5)).reshape(B, Hk, group, D)
    lens = seq_lens.to(dev).long().clamp_min(0)
    steps = torch.clamp(-(-lens // page_size), max=steps_max)
    kv_len = torch.minimum(lens, steps * page_size)

    def runs():
        for p0 in range(0, steps_max, pages_per_split):
            p1 = min(p0 + pages_per_split, steps_max)
            table = page_table[:, p0:p1]
            k = _gather_pages(k_pages, table).float()      # [B, T, Hk, D]
            v = _gather_pages(v_pages, table).float()
            pos = p0 * page_size + torch.arange(k.shape[1], device=dev)
            mask = pos[None] < kv_len[:, None]             # [B, T]
            if k_new is not None and p0 == 0:
                k = torch.cat([k, k_new.float()[:, None]], dim=1)
                v = torch.cat([v, v_new.float()[:, None]], dim=1)
                mask = torch.cat([mask, mask.new_ones(B, 1)], dim=1)
            yield k, v, mask

    out = _merge_split_runs(qf, runs(), logit_softcap)
    return out.reshape(B, H, D).to(q.dtype)


def slot_decode_split_ref(
    q: torch.Tensor,            # [B, H, D]
    k_cache: torch.Tensor,      # [B, S, Hk, D]
    v_cache: torch.Tensor,      # [B, S, Hk, D]
    cache_len: torch.Tensor,    # [B] int
    *,
    tokens_per_split: int,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the slot decode kernel's arithmetic, in float32:
    lane ``b`` attends slots ``[0, min(cache_len, S))``, as
    :func:`decode_attention_ref` masks them without a window; the ring
    is cut into runs of ``tokens_per_split`` slots, each run gives a
    partial and the partials merge in run order (the per-sequence paged
    form with pages of one slot). A ``cache_len`` of 0 gives zeros."""
    B, H, D = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    qf = (q.float() * (D ** -0.5)).reshape(B, Hk, H // Hk, D)
    hi = torch.clamp(cache_len.to(dev).long().clamp_min(0), max=S)

    def runs():
        for t0 in range(0, S, tokens_per_split):
            t1 = min(t0 + tokens_per_split, S)
            pos = torch.arange(t0, t1, device=dev)
            yield (k_cache[:, t0:t1].float(), v_cache[:, t0:t1].float(),
                   pos[None] < hi[:, None])

    out = _merge_split_runs(qf, runs(), logit_softcap)
    return out.reshape(B, H, D).to(q.dtype)


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


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality)
# ---------------------------------------------------------------------------

def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Segment sum: out[..., i, j] = sum_{j < t <= i} a[..., t], and
    -inf above the diagonal (the log-decay matrix of the intra-chunk
    term)."""
    T = a.shape[-1]
    csum = torch.cumsum(a, dim=-1)
    out = csum[..., :, None] - csum[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_naive(
    x: torch.Tensor,            # [B, L, H, P] dt-scaled
    a: torch.Tensor,            # [B, L, H]    log decay per step (<= 0)
    b: torch.Tensor,            # [B, L, G, N]
    c: torch.Tensor,            # [B, L, G, N]
) -> torch.Tensor:
    """Quadratic "attention form" of SSD: y_i = sum_{j<=i} C_i . B_j
    exp(sum_{j<t<=i} a_t) x_j. Oracle for small L."""
    H, G = x.shape[2], b.shape[2]
    rep = H // G
    bf = b.float().repeat_interleave(rep, dim=2)          # [B, L, H, N]
    cf = c.float().repeat_interleave(rep, dim=2)
    lmat = torch.exp(_segsum(a.float().transpose(1, 2)))  # [B, H, L, L]
    scores = torch.einsum("blhn,bshn->bhls", cf, bf) * lmat
    y = torch.einsum("bhls,bshp->blhp", scores, x.float())
    return y.to(x.dtype)


def ssd_chunked(
    x: torch.Tensor,            # [B, L, H, P]
    a: torch.Tensor,            # [B, L, H]
    b: torch.Tensor,            # [B, L, G, N]
    c: torch.Tensor,            # [B, L, G, N]
    *,
    chunk: int = 256,
    return_final_state: bool = False,
):
    """SSD chunked scan (the Mamba-2 paper's ssd_minimal): intra-chunk
    quadratic term plus the inter-chunk recurrent state carry, float32
    inside, y in x's dtype; with ``return_final_state`` also the final
    [B, H, P, N] float32 state.

    A sequence that does not divide the chunk is zero-padded: pad tokens
    have x = 0 (no state injection) and a = 0 (decay exp(0) = 1, state
    unchanged), so outputs at valid positions and the carried state are
    exact. ``chunk > L`` acts as ``chunk = L``."""
    Bsz, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    chunk = max(1, min(chunk, L))
    pad = (-L) % chunk
    L_orig = L
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
        L = L + pad
    nc = L // chunk

    xf = x.float().reshape(Bsz, nc, chunk, H, P)
    af = a.float().reshape(Bsz, nc, chunk, H)
    bf = b.float().reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    cf = c.float().reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    a_t = af.permute(0, 1, 3, 2)                          # [B,nc,H,Q]
    a_cs = torch.cumsum(a_t, dim=-1)                      # inclusive cumsum
    lmat = torch.exp(_segsum(a_t))                        # [B,nc,H,Q,Q]

    # 1) intra-chunk (diagonal blocks)
    scores = torch.einsum("bnqhk,bnshk->bnhqs", cf, bf) * lmat
    y_diag = torch.einsum("bnhqs,bnshp->bnqhp", scores, xf)

    # 2) per-chunk final states: sum_i exp(a_cs[-1] - a_cs[i]) B_i x_i^T
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)       # [B,nc,H,Q]
    states = torch.einsum("bnhq,bnqhk,bnqhp->bnhpk", decay_states, bf, xf)

    # 3) inter-chunk recurrence over the chunk states, emitting the
    #    state from before each chunk
    chunk_decay = torch.exp(a_cs[..., -1])                # [B,nc,H]
    h = x.new_zeros((Bsz, H, P, N), dtype=torch.float32)
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prev = torch.stack(h_prev, dim=1)                   # [B,nc,H,P,N]

    # 4) inter-chunk contribution: y_i += C_i . (exp(a_cs[i]) h_prev)
    in_decay = torch.exp(a_cs)                            # [B,nc,H,Q]
    y_off = torch.einsum("bnqhk,bnhpk,bnhq->bnqhp", cf, h_prev, in_decay)

    y = (y_diag + y_off).reshape(Bsz, L, H, P)[:, :L_orig].to(x.dtype)
    if return_final_state:
        return y, h
    return y


def ssm_decode_step_ref(
    h: torch.Tensor,            # [B, H, P, N] recurrent state, float32
    x_t: torch.Tensor,          # [B, H, P]    dt-scaled input
    a_t: torch.Tensor,          # [B, H]       log decay this step
    b_t: torch.Tensor,          # [B, G, N]
    c_t: torch.Tensor,          # [B, G, N]
):
    """Single-token SSM recurrence (the decode path): ``h' = e^a h +
    x B^T``, ``y = C . h'`` in float32, B and C repeated over the
    ``H / G`` heads of their group. Returns (y [B, H, P] in x's dtype,
    h' [B, H, P, N] float32)."""
    rep = h.shape[1] // b_t.shape[1]
    bf = b_t.float().repeat_interleave(rep, dim=1)         # [B, H, N]
    cf = c_t.float().repeat_interleave(rep, dim=1)
    h_new = (h * torch.exp(a_t.float())[..., None, None]
             + x_t.float()[..., None] * bf[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h_new, cf)
    return y.to(x_t.dtype), h_new


# The SSD scan in the kernel's three stages (csrc/ssd_scan.cu), float32:
# per chunk its inclusive cumsum of the log decays and its local state
# (stage 1), the state carried into each chunk (stage 2), and each
# chunk's output from its own tokens and the carried state (stage 3).
# Every exponent is clamped at 0, as in the kernel. Composed they are
# ssd_chunked's function; the CPU tests hold them to it piece by piece.

def _pad_chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """``t`` [B, L, ...] zero-padded along L to whole chunks, reshaped
    to [B, nc, chunk, ...] in float32."""
    L = t.shape[1]
    pad = (-L) % chunk
    t = t.float()
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)
    return t.reshape((t.shape[0], -1, chunk) + t.shape[2:])


def _decay(z: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(z, max=0.0))


def ssd_chunk_states(
    x: torch.Tensor,            # [B, L, H, P]
    a: torch.Tensor,            # [B, L, H]
    b: torch.Tensor,            # [B, L, G, N]
    *,
    chunk: int,
):
    """Stage 1: (acs [B, nc, H, Q], the inclusive cumsum of ``a`` over
    each zero-padded chunk; states [B, nc, H, P, N], each chunk's local
    state sum_t exp(acs_last - acs_t) x_t b_t^T)."""
    H, G = x.shape[2], b.shape[2]
    xf = _pad_chunks(x, chunk)                                  # [B,nc,Q,H,P]
    bf = _pad_chunks(b, chunk).repeat_interleave(H // G, dim=3)
    acs = torch.cumsum(_pad_chunks(a, chunk).permute(0, 1, 3, 2), dim=-1)
    w = _decay(acs[..., -1:] - acs)                             # [B,nc,H,Q]
    states = torch.einsum("bnhq,bnqhk,bnqhp->bnhpk", w, bf, xf)
    return acs, states


def ssd_state_pass(states: torch.Tensor, acs: torch.Tensor):
    """Stage 2: (h_in [B, nc, H, P, N], the state carried into each
    chunk, zero into the first; the final state [B, H, P, N]), from
    h_in[c] = exp(acs_last[c - 1]) h_in[c - 1] + states[c - 1]."""
    keep = _decay(acs[..., -1])                                 # [B,nc,H]
    h = torch.zeros_like(states[:, 0])
    h_in = []
    for n in range(states.shape[1]):
        h_in.append(h)
        h = h * keep[:, n, :, None, None] + states[:, n]
    return torch.stack(h_in, dim=1), h


def ssd_chunk_scan(
    x: torch.Tensor,            # [B, L, H, P]
    b: torch.Tensor,            # [B, L, G, N]
    c: torch.Tensor,            # [B, L, G, N]
    acs: torch.Tensor,          # [B, nc, H, Q] from ssd_chunk_states
    h_in: torch.Tensor,         # [B, nc, H, P, N] from ssd_state_pass
) -> torch.Tensor:
    """Stage 3: y [B, L, H, P] float32, y_i = sum_{j <= i} (C_i . B_j)
    exp(acs_i - acs_j) x_j + exp(acs_i) C_i . h_in^T within each chunk;
    C . B^T once per group."""
    Bsz, L, H, P = x.shape
    G = b.shape[2]
    chunk = acs.shape[-1]
    xf = _pad_chunks(x, chunk)                                  # [B,nc,Q,H,P]
    bf, cf = _pad_chunks(b, chunk), _pad_chunks(c, chunk)       # [B,nc,Q,G,N]
    cb = torch.einsum("bnqgk,bnsgk->bngqs", cf, bf)             # [B,nc,G,Q,Q]
    cb = cb.repeat_interleave(H // G, dim=2)                    # [B,nc,H,Q,Q]
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))
    scores = torch.where(causal, cb * _decay(acs[..., :, None]
                                             - acs[..., None, :]),
                         cb.new_zeros(()))
    y = torch.einsum("bnhqs,bnshp->bnqhp", scores, xf)
    cr = cf.repeat_interleave(H // G, dim=3)                    # [B,nc,Q,H,N]
    y = y + torch.einsum("bnqhk,bnhpk,bnhq->bnqhp", cr, h_in, _decay(acs))
    return y.reshape(Bsz, -1, H, P)[:, :L]


def ssd_chunked_pieces(
    x: torch.Tensor,            # [B, L, H, P]
    a: torch.Tensor,            # [B, L, H]
    b: torch.Tensor,            # [B, L, G, N]
    c: torch.Tensor,            # [B, L, G, N]
    *,
    chunk: int = 256,
    return_final_state: bool = False,
):
    """``ssd_chunked`` composed from the kernel's three stages: y in x's
    dtype (and the final state with ``return_final_state``)."""
    chunk = max(1, min(chunk, x.shape[1]))
    acs, states = ssd_chunk_states(x, a, b, chunk=chunk)
    h_in, final = ssd_state_pass(states, acs)
    y = ssd_chunk_scan(x, b, c, acs, h_in).to(x.dtype)
    return (y, final) if return_final_state else y
