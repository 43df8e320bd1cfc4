"""The port's plain kernel versions against the JAX Pallas kernels.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs the Pallas kernels in interpret mode on the CPU, as
``tests/test_kernels.py`` does; the port side runs ``kernels.ops`` with
``impl='auto'`` on CPU tensors, which is the plain PyTorch version (the
CUDA kernels are held against it on the card by ``test_torch_cuda.py``
and ``chip_smoke.py``). Sweeps mirror ``tests/test_kernels.py``: GQA
groups, chunk x cached prefix, softcap, the ``max_pages`` trim and
poisoned page-table tails; for flash attention causal, sliding window,
prefix-LM, softcap, queries aligned to the end of longer keys and
ragged key lengths; for per-sequence paged decode poisoned tails and an
empty sequence.

Tolerances: float32 ``atol=rtol=1e-5`` (same math, summation order
differs); bfloat16 ``atol=rtol=2e-2`` (outputs round to bf16, 8 mantissa
bits, at different points of the two pipelines).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import batched_paged_decode_attention as jax_decode
from repro.kernels import chunked_prefill_attention as jax_prefill
from repro.kernels import flash_attention as jax_flash
from repro.kernels import paged_decode_attention as jax_paged
from repro.kernels import ref as jax_ref
from repro_torch.kernels import (chunked_prefill, flash_attention, ops,
                                 paged_attention, ref)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
            else dict(atol=1e-5, rtol=1e-5))


def _both(x, dtype):
    """One numpy float32 array as (jax, torch) arrays of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _ints(x):
    x = np.asarray(x, np.int32)
    return jnp.asarray(x), torch.from_numpy(x)


def _page_scene(rng, B, Hk, D, page, pps, extra=3):
    """Random pool + non-overlapping per-sequence page tables."""
    n_pages = B * pps + extra
    k = rng.standard_normal((n_pages, page, Hk, D), dtype=np.float32)
    v = rng.standard_normal((n_pages, page, Hk, D), dtype=np.float32)
    table = rng.permutation(n_pages)[:B * pps].reshape(B, pps).astype(np.int32)
    return k, v, table


def _close(got_torch, want_jax, dtype):
    np.testing.assert_allclose(got_torch.float().numpy(),
                               np.asarray(want_jax, np.float32), **_tol(dtype))


def _decode_case(rng, B, H, Hk, D, page, pps, seq_lens, dtype, *,
                 max_pages=None, softcap=None, poison=False):
    k, v, table = _page_scene(rng, B, Hk, D, page, pps)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kn = rng.standard_normal((B, Hk, D), dtype=np.float32)
    vn = rng.standard_normal((B, Hk, D), dtype=np.float32)
    poisoned = table.copy()
    if poison:
        for b, n in enumerate(seq_lens):
            poisoned[b, -(-n // page):] = k.shape[0] * 13 + b
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    (knj, knt), (vnj, vnt) = _both(kn, dtype), _both(vn, dtype)
    (ptj, ptt), (lj, lt) = _ints(poisoned), _ints(seq_lens)
    want = jax_decode(qj, kj, vj, _ints(table)[0], lj, knj, vnj,
                      max_pages=max_pages, logit_softcap=softcap,
                      interpret=True)
    before = paged_attention.launches
    got = ops.batched_paged_decode_attention(
        qt, kt, vt, ptt, lt, knt, vnt, max_pages=max_pages,
        logit_softcap=softcap)
    assert paged_attention.launches == before   # CPU: the plain version
    assert got.dtype == qt.dtype and got.shape == (B, H, D)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("B,H,Hk,D,page,pps", [
    (3, 4, 2, 32, 8, 6),        # GQA group 2
    (2, 9, 3, 64, 16, 4),       # the full-width smollm head layout
    (3, 8, 1, 24, 8, 4),        # MQA, the smoke head_dim
])
def test_batched_decode_matches_pallas(B, H, Hk, D, page, pps, trim, dtype):
    rng = np.random.default_rng(10)
    seq_lens = [(5 + 13 * b) % (page * pps - 1) for b in range(B)]
    mp = max(1, -(-max(seq_lens) // page)) if trim else None
    _decode_case(rng, B, H, Hk, D, page, pps, seq_lens, dtype, max_pages=mp)


def test_batched_decode_softcap_and_empty_sequence():
    rng = np.random.default_rng(11)
    _decode_case(rng, 2, 8, 2, 16, 8, 4, [0, 23], "float32", softcap=30.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_decode_ignores_poisoned_tail(dtype):
    rng = np.random.default_rng(15)
    _decode_case(rng, 2, 4, 2, 32, 8, 6, [11, 37], dtype, poison=True)


def _prefill_case(rng, B, chunk, Hk, group, D, page, pps, q_offsets, dtype,
                  *, softcap=None, poison=False):
    H = Hk * group
    k, v, table = _page_scene(rng, B, Hk, D, page, pps)
    q = rng.standard_normal((B, chunk, H, D), dtype=np.float32)
    kv_lens = [o + chunk for o in q_offsets]
    poisoned = table.copy()
    if poison:
        for b, n in enumerate(kv_lens):
            poisoned[b, -(-n // page):] = k.shape[0] * 13 + b
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    (oj, ot), (lj, lt) = _ints(q_offsets), _ints(kv_lens)
    want = jax_prefill(qj, kj, vj, _ints(table)[0], oj, lj,
                       logit_softcap=softcap, interpret=True)
    before = chunked_prefill.launches
    got = ops.chunked_prefill_attention(qt, kt, vt, _ints(poisoned)[1], ot,
                                        lt, logit_softcap=softcap)
    assert chunked_prefill.launches == before
    assert got.dtype == qt.dtype and got.shape == (B, chunk, H, D)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,cached,group", [
    (16, 0, 1),     # first chunk, MHA
    (16, 16, 2),    # resume from one cached page row, GQA
    (8, 24, 3),     # small slab deep in the sequence, the smollm group
    (32, 32, 4),    # wide slab, wide GQA group
    (12, 20, 1),    # non-page-aligned slab boundary
    (1, 40, 3),     # C = 1: the engine's fully-cached re-run
])
def test_chunked_prefill_matches_pallas(chunk, cached, group, dtype):
    rng = np.random.default_rng(12)
    # second sequence resumes from a non-page-aligned offset
    _prefill_case(rng, 2, chunk, 2, group, 32, 8, 12,
                  [cached, max(0, cached - 3)], dtype)


def test_chunked_prefill_softcap():
    rng = np.random.default_rng(13)
    _prefill_case(rng, 1, 16, 2, 2, 16, 8, 8, [24], "float32", softcap=30.0)


def test_chunked_prefill_ignores_poisoned_tail():
    rng = np.random.default_rng(15)
    _prefill_case(rng, 2, 8, 2, 2, 32, 8, 6, [3, 29], "float32", poison=True)


def test_chunked_prefill_rows_past_kv_len_are_zero():
    """Rows whose position lies at or past kv_len have no keys: zeros."""
    rng = np.random.default_rng(16)
    k, v, table = _page_scene(rng, 1, 1, 8, 4, 4)
    q = torch.from_numpy(rng.standard_normal((1, 6, 2, 8), dtype=np.float32))
    out = ref.chunked_prefill_attention_ref(
        q, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(table),
        torch.tensor([2]), torch.tensor([5]))
    assert torch.all(out[0, 3:] == 0) and torch.all(out[0, :3] != 0)


def _qkv(rng, B, Lq, Lk, H, Hk, D, dtype):
    q = rng.standard_normal((B, Lq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Lk, Hk, D), dtype=np.float32)
    v = rng.standard_normal((B, Lk, Hk, D), dtype=np.float32)
    return [_both(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Lq,Lk,H,Hk,D,kw", [
    (2, 40, 40, 4, 4, 16, dict()),                       # MHA, causal
    (1, 40, 40, 6, 2, 24, dict(window=16)),              # window bites
    (1, 37, 37, 9, 3, 24, dict(prefix_len=8)),           # prefix-LM
    (2, 24, 24, 8, 2, 80, dict(logit_softcap=30.0)),     # D 80, group 4
    (1, 1, 37, 3, 1, 16, dict()),                        # Lq 1 < Lk
    (2, 5, 37, 4, 1, 16, dict(window=16, prefix_len=8)), # Lq 5 < Lk
    (1, 19, 19, 3, 3, 24, dict(causal=False)),           # non-causal
    # more queries than keys: a decoder bucket against whisper's frames
    (2, 32, 16, 4, 4, 16, dict(causal=False)),           # cross-attention
    (1, 40, 16, 4, 4, 16, dict()),                       # causal, empty rows
    (1, 70, 64, 9, 3, 16, dict(window=16)),
])
def test_attention_matches_pallas(B, Lq, Lk, H, Hk, D, kw, dtype):
    rng = np.random.default_rng(20)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, B, Lq, Lk, H, Hk, D, dtype)
    want = jax_flash(qj, kj, vj, block_q=16, block_kv=16, interpret=True,
                     **{"causal": True, **kw})
    before = flash_attention.launches
    got = ops.attention(qt, kt, vt, impl="reference", **kw)
    auto = ops.attention(qt, kt, vt, **kw)        # CPU: the plain version
    assert flash_attention.launches == before
    assert got.dtype == qt.dtype and got.shape == (B, Lq, H, D)
    _close(got, want, dtype)
    assert torch.equal(auto, got)


@pytest.mark.parametrize("kw", [dict(), dict(window=12), dict(prefix_len=8),
                                dict(causal=False, logit_softcap=5.0)])
def test_attention_plain_versions_agree(kw):
    """The port's ``mha_naive`` matches the JAX one, and its chunked
    online-softmax form matches its naive form at block sizes that do
    and do not divide ``Lk``."""
    rng = np.random.default_rng(21)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, 9, 29, 6, 2, 16, "float32")
    naive = ref.mha_naive(qt, kt, vt, **kw)
    _close(naive, jax_ref.mha_naive(qj, kj, vj, **kw), "float32")
    for block in (8, 29, 512):
        torch.testing.assert_close(
            ref.flash_attention_chunked(qt, kt, vt, block_kv=block, **kw),
            naive, atol=1e-5, rtol=1e-5)


def test_attention_refuses_more_queries_than_keys():
    """The wrapper takes more queries than keys (the decoder's
    cross-attention over a shorter encoder), with JAX's semantics:
    query ``i`` sits at ``Lk - Lq + i``, a causal row at a negative
    position sees no key and is zeros. It refuses heads that do not
    group."""
    rng = np.random.default_rng(22)
    for kw in (dict(), dict(causal=False), dict(window=4)):
        (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, 12, 5, 4, 2, 16,
                                            "float32")
        got = flash_attention.flash_attention(qt, kt, vt, **kw)
        want = jax_flash(qj, kj, vj, block_q=16, block_kv=16, interpret=True,
                         **{"causal": True, **kw})
        _close(got, want, "float32")
        if kw.get("causal", True):
            assert not got[:, :7].any() and got[:, 7:].all()
    q = torch.zeros(1, 5, 3, 8)
    k = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="do not group"):
        flash_attention.flash_attention(q, k, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hk,D,page,pps,softcap", [
    (3, 4, 2, 32, 8, 6, None),     # GQA group 2
    (4, 9, 3, 64, 16, 4, 30.0),    # the full-width smollm head layout
])
def test_paged_decode_matches_pallas(B, H, Hk, D, page, pps, softcap, dtype):
    """Per-sequence paged decode with a seq_len 0 row and poisoned
    table tails (the port reads them never; the JAX index map clamps)."""
    rng = np.random.default_rng(22)
    k, v, table = _page_scene(rng, B, Hk, D, page, pps)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    seq_lens = [0] + [(9 + 11 * b) % (page * pps) + 1 for b in range(1, B)]
    poisoned = table.copy()
    for b, n in enumerate(seq_lens):
        poisoned[b, -(-n // page):] = k.shape[0] * 13 + b
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    (ptj, ptt), (lj, lt) = _ints(poisoned), _ints(seq_lens)
    want = jax_paged(qj, kj, vj, ptj, lj, logit_softcap=softcap,
                     interpret=True)
    before = paged_attention.paged_decode_launches
    got = ops.paged_decode_attention(qt, kt, vt, ptt, lt,
                                     logit_softcap=softcap, impl="reference")
    auto = ops.paged_decode_attention(qt, kt, vt, ptt, lt,
                                      logit_softcap=softcap)
    assert paged_attention.paged_decode_launches == before
    assert got.dtype == qt.dtype and got.shape == (B, H, D)
    assert torch.all(got[0] == 0)
    _close(got, want, dtype)
    assert torch.equal(auto, got)


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None),
                                            (12, 30.0)])
def test_decode_attention_window_matches_jax_ref(window, softcap):
    rng = np.random.default_rng(23)
    B, S, H, Hk, D = 3, 16, 6, 2, 24
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hk, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hk, D), dtype=np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, "float32") for a in (q, k, v))
    lj, lt = _ints([1, 9, 16])
    want = jax_ref.decode_attention_ref(qj, kj, vj, lj, window=window,
                                        logit_softcap=softcap)
    got = ops.decode_attention(qt, kt, vt, lt, window=window,
                               logit_softcap=softcap)
    _close(got, want, "float32")


def test_ops_refuse_cuda_impl_for_cpu_tensors():
    """No silent fallback: impl='cuda' on a CPU tensor raises."""
    rng = np.random.default_rng(17)
    k, v, table = _page_scene(rng, 1, 1, 8, 4, 2)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    pt = torch.from_numpy(table)
    with pytest.raises(ValueError, match="CUDA"):
        ops.batched_paged_decode_attention(
            torch.zeros(1, 2, 8), kt, vt, pt, torch.tensor([3]),
            torch.zeros(1, 1, 8), torch.zeros(1, 1, 8), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.chunked_prefill_attention(
            torch.zeros(1, 2, 2, 8), kt, vt, pt, torch.tensor([0]),
            torch.tensor([2]), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(torch.zeros(1, 2, 8), kt, vt, pt,
                                   torch.tensor([3]), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(torch.zeros(1, 2, 2, 8), torch.zeros(1, 2, 1, 8),
                      torch.zeros(1, 2, 1, 8), impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.chunked_prefill_attention(
            torch.zeros(1, 2, 2, 8), kt, vt, pt, torch.tensor([0]),
            torch.tensor([2]), impl="pallas")


def test_library_path_hashes_every_header(tmp_path, monkeypatch):
    """A library's cache key covers its ``.cu`` and every ``.cuh`` under
    ``csrc/``, so a header edit rebuilds the sources that include it.
    Nothing is built: only the names are computed."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (csrc / "a.cu").write_text('#include "tile.cuh"\nint x;\n')
    (csrc / "tile.cuh").write_text("int y;\n")
    first = _build._lib_path("a")
    assert first.parent == tmp_path / "build" and first.name.startswith("a-")
    assert _build._lib_path("a") == first
    (csrc / "tile.cuh").write_text("int y = 1;\n")
    assert _build._lib_path("a") != first
    (csrc / "tile.cuh").write_text("int y;\n")
    assert _build._lib_path("a") == first
    (csrc / "a.cu").write_text('#include "tile.cuh"\nint x = 2;\n')
    assert _build._lib_path("a") != first
    (csrc / "a.cu").write_text('#include "tile.cuh"\nint x;\n')
    (csrc / "other.cuh").write_text("int z;\n")
    assert _build._lib_path("a") != first
    assert not (tmp_path / "build").exists()


def test_misaligned_operand_is_copied_to_16_bytes():
    """The bf16 kernels copy rows 16 bytes at a time: a contiguous view
    that starts mid-row reaches them as an aligned copy, values equal."""
    base = torch.arange(40, dtype=torch.bfloat16)
    view = base[1:33].view(1, 1, 4, 8)
    assert view.is_contiguous() and view.data_ptr() % 16
    got = flash_attention.aligned16(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    aligned = base[:32]
    assert flash_attention.aligned16(aligned) is aligned
