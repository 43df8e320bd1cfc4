"""The split-page decode kernels' arithmetic and plan, on the CPU.

``ref.paged_decode_split_ref`` is the plain version of what the CUDA
decode kernels compute in their own order: the page axis cut into runs
of ``pages_per_split`` whole pages, a partial softmax state per run,
merged in run order, the fused token in run 0. Here it is held against
the JAX Pallas kernels in interpret mode (``batched_paged_decode_attention``
and ``paged_decode_attention``) and against the port's unsplit plain
versions, over runs of 1, 2, 3 and all pages, lengths on a run's edge,
a ``seq_len`` of 0, a trimmed ``max_pages``, softcap 30 and poisoned
page-table tails. Inputs are made with numpy from a seed.

Also: ``paged_attention.split_plan`` on ints (the runs tile the page
axis in whole pages), each C entry point's parameter count against
``_build.SIGNATURES``, the pool alignment check, and the paged decode
step handing every layer the same int32 lengths and table.

Tolerances: float32 ``atol=rtol=1e-5`` (same math, summation order
differs); bfloat16 ``atol=rtol=2e-2`` (outputs round to bf16 at
different points of the two pipelines), as in ``test_torch_kernels.py``.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import batched_paged_decode_attention as jax_decode
from repro.kernels import paged_decode_attention as jax_paged
from repro_torch.configs import smoke_config
from repro_torch.kernels import (_build, flash_attention, ops,
                                 paged_attention, ref)
from repro_torch.models import transformer
from repro_torch.models.registry import get_api

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
H, HK, D, PAGE, PPS = 6, 2, 32, 8, 8      # group 3, as full-width smollm
# lengths on the edges of 1-, 2- and 3-page runs (16, 24, 48), one
# before an edge (47), the table's last token (63) and an empty slot
FULL = [0, 16, 24, 47, 48, 63]
# the batched kernel trimmed to 5 pages: its last 3-page run is short
TRIMMED, TRIM_PAGES = [0, 16, 24, 31, 7, 33], 5


def _tol(dtype):
    return (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
            else dict(atol=1e-5, rtol=1e-5))


@functools.lru_cache(maxsize=None)
def _scene(lens, dtype, poison):
    """numpy float32 pool, queries and fused K/V; the table, poisoned past
    each length if asked; the same as torch tensors of ``dtype``."""
    rng = np.random.default_rng(31)
    B = len(lens)
    n_pages = B * PPS + 3
    k = rng.standard_normal((n_pages, PAGE, HK, D), dtype=np.float32)
    v = rng.standard_normal((n_pages, PAGE, HK, D), dtype=np.float32)
    table = rng.permutation(n_pages)[:B * PPS].reshape(B, PPS).astype(np.int32)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    kn = rng.standard_normal((B, HK, D), dtype=np.float32)
    vn = rng.standard_normal((B, HK, D), dtype=np.float32)
    if poison:
        for b, n in enumerate(lens):
            table[b, -(-n // PAGE):] = n_pages * 13 + b
    td = DTYPES[dtype][1]
    arrays = dict(q=q, k=k, v=v, kn=kn, vn=vn, table=table,
                  lens=np.asarray(lens, np.int32))
    tensors = {n: torch.from_numpy(a) if a.dtype == np.int32
               else torch.from_numpy(a).to(td) for n, a in arrays.items()}
    return arrays, tensors


@functools.lru_cache(maxsize=None)
def _jax_batched(lens, dtype, poison, max_pages, softcap):
    a, _ = _scene(lens, dtype, poison)
    jd = DTYPES[dtype][0]
    out = jax_decode(*(jnp.asarray(a[n]).astype(jd) for n in ("q", "k", "v")),
                     jnp.asarray(a["table"]), jnp.asarray(a["lens"]),
                     jnp.asarray(a["kn"]).astype(jd),
                     jnp.asarray(a["vn"]).astype(jd), max_pages=max_pages,
                     logit_softcap=softcap, interpret=True)
    return np.asarray(out, np.float32)


@functools.lru_cache(maxsize=None)
def _jax_paged(lens, dtype, poison, softcap):
    a, _ = _scene(lens, dtype, poison)
    jd = DTYPES[dtype][0]
    out = jax_paged(*(jnp.asarray(a[n]).astype(jd) for n in ("q", "k", "v")),
                    jnp.asarray(a["table"]), jnp.asarray(a["lens"]),
                    logit_softcap=softcap, interpret=True)
    return np.asarray(out, np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hard", [False, True], ids=["plain", "softcap-poisoned"])
@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("per", [1, 2, 3, None], ids=["1", "2", "3", "all"])
def test_split_ref_matches_batched_pallas(per, trim, hard, dtype):
    lens, steps = (tuple(TRIMMED), TRIM_PAGES) if trim else (tuple(FULL), PPS)
    softcap = 30.0 if hard else None
    _, t = _scene(lens, dtype, hard)
    got = ref.paged_decode_split_ref(
        t["q"], t["k"], t["v"], t["table"], t["lens"], t["kn"], t["vn"],
        pages_per_split=per or steps, n_page_steps=steps,
        logit_softcap=softcap)
    assert got.dtype == t["q"].dtype and got.shape == t["q"].shape
    _close(got, _jax_batched(lens, dtype, hard, steps if trim else None,
                             softcap), dtype)
    _, clean = _scene(lens, dtype, False)     # the unsplit plain version
    want = ref.batched_paged_decode_attention_ref(
        clean["q"], clean["k"], clean["v"], clean["table"], clean["lens"],
        clean["kn"], clean["vn"], logit_softcap=softcap)
    _close(got, want.float().numpy(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hard", [False, True], ids=["plain", "softcap-poisoned"])
@pytest.mark.parametrize("per", [1, 2, 3, None], ids=["1", "2", "3", "all"])
def test_split_ref_matches_paged_pallas(per, hard, dtype):
    lens = tuple(FULL[:-1]) + (PPS * PAGE,)     # B3 may fill its table
    softcap = 30.0 if hard else None
    _, t = _scene(lens, dtype, hard)
    got = ref.paged_decode_split_ref(
        t["q"], t["k"], t["v"], t["table"], t["lens"],
        pages_per_split=per or PPS, logit_softcap=softcap)
    assert torch.all(got[0] == 0)             # seq_len 0 -> zeros
    _close(got, _jax_paged(lens, dtype, hard, softcap), dtype)
    _, clean = _scene(lens, dtype, False)
    want = ref.paged_decode_attention_ref(
        clean["q"], clean["k"], clean["v"], clean["table"], clean["lens"],
        logit_softcap=softcap)
    _close(got, want.float().numpy(), dtype)


def test_split_ref_empty_slot_attends_its_own_token():
    """Batched form, seq_len 0: the fused token is the only key, so the
    output is its value for every head of the group (run 0 exists even
    when no page does)."""
    _, t = _scene(tuple(FULL), "float32", True)
    got = ref.paged_decode_split_ref(
        t["q"], t["k"], t["v"], t["table"], t["lens"], t["kn"], t["vn"],
        pages_per_split=2, n_page_steps=PPS)
    want = t["vn"][0].repeat_interleave(H // HK, dim=0)
    torch.testing.assert_close(got[0], want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("page_size", [1, 8, 16, 32])
@pytest.mark.parametrize("B,Hk", [(1, 1), (2, 3), (8, 3), (4, 8), (64, 8)])
def test_split_plan_tiles_the_page_axis(B, Hk, page_size):
    for n in list(range(1, 70)) + [128, 255, 256, 1024]:
        per, S = paged_attention.split_plan(B, Hk, n, page_size)
        assert isinstance(per, int) and isinstance(S, int)
        assert S >= 1 and 1 <= per <= n
        assert per * S >= n                   # every page in some run
        assert per * (S - 1) < n              # no run starts past the axis
        assert B * Hk * S <= max(B * Hk, 2 * paged_attention._BLOCKS_PER_SM
                                 * paged_attention._SMS)


def test_split_plan_at_the_engines_shapes():
    # 8 slots x 3 kv heads, 16 pages of 16: 2-page runs, 192 blocks
    assert paged_attention.split_plan(8, 3, 16, 16) == (2, 8)
    # the long scene's 128-page tables: 8-page runs, 384 blocks
    assert paged_attention.split_plan(8, 3, 128, 16) == (8, 16)
    assert paged_attention.split_plan(8, 3, 1, 16) == (1, 1)
    with pytest.raises(ValueError):
        paged_attention.split_plan(8, 3, 0, 16)


def test_entry_points_match_their_ctypes_signatures():
    """Each ``extern "C"`` entry in ``csrc/*.cu`` takes as many parameters
    as its ``_build.SIGNATURES`` list gives ctypes (a mismatch shows on
    the card only, as a crash)."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in re.findall(
                r'extern\s+"C"\s+\w+\s+(\w+)\s*\(([^)]*)\)', text):
            found[(src.stem, name)] = len([p for p in params.split(",")
                                           if p.strip()])
    want = {(src, name): len(types)
            for src, entries in _build.SIGNATURES.items()
            for name, types in entries.items()}
    assert found == want


def test_pools_must_start_on_16_bytes():
    """The kernels load pool rows 16 bytes at a time; a pool that starts
    mid-row is refused, never copied."""
    base = torch.zeros(2 * PAGE * HK * D + 1, dtype=torch.bfloat16)
    pool = base[1:].view(2, PAGE, HK, D)
    assert pool.is_contiguous() and pool.data_ptr() % 16
    q = torch.zeros(1, H, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        paged_attention.check_operands(q, pool, pool)
    aligned = base[:-1].view(2, PAGE, HK, D)
    paged_attention.check_operands(q, aligned, aligned)
    # q, k_new and v_new reach the kernels through the flash wrappers'
    # 16-byte alignment copy
    assert flash_attention.aligned16 is _build.aligned16


def test_decode_step_hands_every_layer_the_same_int32_operands(monkeypatch):
    """The paged decode step makes the kernel's int32 lengths and table
    once and passes those tensors to every layer, so the wrapper casts
    nothing per layer; results as the engine's int32 inputs give."""
    cfg = smoke_config("smollm-135m").replace(dtype="float32")
    params = get_api(cfg).init(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rng = np.random.default_rng(5)
    B, n_pages = 3, 3 * PPS + 1
    shape = (cfg.n_layers, n_pages, PAGE, cfg.n_kv_heads, cfg.d_head)
    k = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    table = torch.from_numpy(
        rng.permutation(n_pages)[:B * PPS].reshape(B, PPS).astype(np.int32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, B))
    seen = []
    plain = ops.batched_paged_decode_attention

    def spy(q, kp, vp, page_table, seq_lens, *rest, **kw):
        seen.append((page_table, seq_lens))
        return plain(q, kp, vp, page_table, seq_lens, *rest, **kw)

    monkeypatch.setattr(ops, "batched_paged_decode_attention", spy)
    logits = {}
    for name, lens in (("int64", torch.tensor([5, 16, 0])),
                       ("int32", torch.tensor([5, 16, 0], dtype=torch.int32))):
        seen.clear()
        logits[name] = transformer.decode_step_paged(
            cfg, params, {"k": k.clone(), "v": v.clone()}, tokens,
            table.long() if name == "int64" else table, lens, max_pages=4)
        assert len(seen) == cfg.n_layers
        for pt, sl in seen:
            assert pt is seen[0][0] and sl is seen[0][1]
            assert pt.dtype == sl.dtype == torch.int32
            assert pt.is_contiguous() and sl.is_contiguous()
    assert torch.equal(logits["int64"], logits["int32"])
