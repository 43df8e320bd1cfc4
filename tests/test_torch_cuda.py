"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA GPU and nvcc: they build ``kernels/csrc`` and
launch each kernel through its wrapper. Without CUDA they skip, unless
``REPRO_TORCH_REQUIRE_CUDA=1`` says the run is on the GPU machine, where
a missing GPU is a failure:

    REPRO_TORCH_REQUIRE_CUDA=1 PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: float32 ``atol=rtol=2e-5``; bfloat16 ``atol=rtol=1e-2``
(both versions sum in float32; they differ in order only, so bf16
outputs are at most about one bf16 ulp apart). Gradients through the
kernels' autograd Functions against plain autograd: the backward is the
same plain code on both sides, recomputed from the same inputs, and the
forward outputs differ within the tolerances above, so the gradients
agree to float32 rounding, ``atol=rtol=1e-4`` (float32 inputs). The
SSD scan's float32 outputs sum terms as large as the call's largest
outputs, so their rounding error scales with ``max |y|``: float32 atol
``1e-5 * max |y|`` there.
"""

import os

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.scheduler import DriftScheduler
from repro_torch.distributed.optimizer import Optimizer, OptimizerConfig
from repro_torch.kernels import (chunked_prefill, flash_attention, ops,
                                 paged_attention, ref, ssd_scan)
from repro_torch.models import transformer
from repro_torch.models.registry import get_api
from repro_torch.models.steps import make_train_step
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs (never at import)."""
    if torch.cuda.is_available():
        return torch.device("cuda", 0)
    if os.environ.get("REPRO_TORCH_REQUIRE_CUDA") == "1":
        pytest.fail("REPRO_TORCH_REQUIRE_CUDA=1 but CUDA is not available")
    pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")


def _scene(gen, dev, B, Hk, D, P, pps, dtype):
    n_pages = B * pps + 3
    k = torch.randn(n_pages, P, Hk, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(n_pages, P, Hk, D, generator=gen, device=dev).to(dtype)
    table = torch.randperm(n_pages, generator=gen, device=dev)[:B * pps]
    return k, v, table.reshape(B, pps).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hk,D,P,pps", [
    (3, 3, 1, 24, 8, 12),        # smoke smollm
    (8, 9, 3, 64, 16, 32),       # full-width smollm
])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_kernel_matches_plain(cuda, B, H, Hk, D, P, pps, softcap,
                                     dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    k, v, table = _scene(gen, cuda, B, Hk, D, P, pps, dtype)
    q = torch.randn(B, H, D, generator=gen, device=cuda).to(dtype)
    kn = torch.randn(B, Hk, D, generator=gen, device=cuda).to(dtype)
    vn = torch.randn(B, Hk, D, generator=gen, device=cuda).to(dtype)
    lens = [0] + [(11 + 29 * b) % (P * pps - 1) for b in range(1, B)]
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    poisoned = table.clone()
    for b, n in enumerate(lens):
        poisoned[b, -(-n // P):] = k.shape[0] * 13 + b
    before = paged_attention.launches
    got = ops.batched_paged_decode_attention(
        q, k, v, poisoned, sl, kn, vn, logit_softcap=softcap, impl="cuda")
    want = ops.batched_paged_decode_attention(
        q, k, v, table, sl, kn, vn, logit_softcap=softcap, impl="reference")
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 16, 128])
@pytest.mark.parametrize("B,H,Hk,D,P,pps", [
    (2, 3, 1, 24, 8, 24),        # smoke smollm
    (2, 9, 3, 64, 16, 32),       # full-width smollm
])
def test_prefill_kernel_matches_plain(cuda, B, H, Hk, D, P, pps, C, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    k, v, table = _scene(gen, cuda, B, Hk, D, P, pps, dtype)
    q = torch.randn(B, C, H, D, generator=gen, device=cuda).to(dtype)
    off = torch.tensor([min(P * pps - C, 40 + 7 * b) for b in range(B)],
                       dtype=torch.int32, device=cuda)
    before = chunked_prefill.launches
    got = ops.chunked_prefill_attention(q, k, v, table, off, off + C,
                                        impl="cuda")
    want = ops.chunked_prefill_attention(q, k, v, table, off, off + C,
                                         impl="reference")
    torch.cuda.synchronize()
    assert chunked_prefill.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,H,Hk,D,kw", [
    (2, 40, 40, 3, 1, 24, dict()),                          # smoke smollm
    (1, 256, 256, 9, 3, 64, dict()),                        # the engine's
    (8, 512, 512, 9, 3, 64, dict()),                        # the trainer's
    (1, 256, 256, 32, 8, 80, dict(window=64, prefix_len=16)),  # h2o-danube
    (1, 16, 200, 8, 2, 256, dict(logit_softcap=30.0)),      # > 48 KB smem
    (2, 1, 200, 9, 3, 64, dict(window=64)),                 # Lq 1
])
def test_flash_kernel_matches_plain(cuda, B, Lq, Lk, H, Hk, D, kw, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(B, Lq, H, D, generator=gen, device=cuda).to(dtype)
    k = torch.randn(B, Lk, Hk, D, generator=gen, device=cuda).to(dtype)
    v = torch.randn(B, Lk, Hk, D, generator=gen, device=cuda).to(dtype)
    before = flash_attention.launches
    got = ops.attention(q, k, v, impl="cuda", **kw)
    want = ops.attention(q, k, v, impl="reference", **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# The bf16 kernels work in 64-row tiles (query position x group) and
# 64-key tiles: ragged row and key counts, mask edges inside a tile, and
# head dims padded to the tensor-core depth of 16 (24 -> 32, 80 -> 96).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,H,Hk,D,kw", [
    (2, 50, 50, 9, 3, 64, dict()),                   # 150 rows: 2.3 tiles
    (1, 70, 200, 9, 3, 64, dict()),                  # Lk 200, not 64k
    (1, 100, 200, 8, 2, 64, dict(window=40, prefix_len=20)),  # edges mid-tile
    (1, 96, 131, 6, 2, 64, dict(causal=False, window=70)),
    (2, 37, 77, 3, 1, 24, dict(prefix_len=70, logit_softcap=30.0)),  # D 24
    (1, 90, 150, 32, 8, 80, dict(window=33, prefix_len=5)),  # D 80
    (1, 40, 90, 8, 2, 256, dict(window=50)),                 # D 256
])
def test_flash_kernel_tile_edges(cuda, B, Lq, Lk, H, Hk, D, kw, dtype):
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(B, Lq, H, D, generator=gen, device=cuda).to(dtype)
    k = torch.randn(B, Lk, Hk, D, generator=gen, device=cuda).to(dtype)
    v = torch.randn(B, Lk, Hk, D, generator=gen, device=cuda).to(dtype)
    before = flash_attention.launches
    got = ops.attention(q, k, v, impl="cuda", **kw)
    want = ops.attention(q, k, v, impl="reference", **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# q_offset 128 (a prefix-cache hit), ragged row counts, kv_len ending
# mid-page and, for the second sequence, before the chunk ends (its
# later rows are zeros); the table past each kv_len is poisoned.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,H,Hk,D", [
    (128, 9, 3, 64),            # the engine's chunk
    (100, 9, 3, 64),            # 300 rows
    (50, 3, 1, 24),             # D 24
    (70, 32, 8, 80),            # D 80
    (33, 8, 2, 256),            # D 256
])
def test_prefill_kernel_tile_edges(cuda, C, H, Hk, D, dtype):
    P, pps = 16, 24
    gen = torch.Generator(device=cuda).manual_seed(9)
    k, v, table = _scene(gen, cuda, 2, Hk, D, P, pps, dtype)
    q = torch.randn(2, C, H, D, generator=gen, device=cuda).to(dtype)
    off = torch.tensor([128, 128], dtype=torch.int32, device=cuda)
    lens = [128 + C, 128 + C // 2 + 3]
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    poisoned = table.clone()
    for b, n in enumerate(lens):
        poisoned[b, -(-n // P):] = k.shape[0] * 13 + b
    before = chunked_prefill.launches
    got = ops.chunked_prefill_attention(q, k, v, poisoned, off, kv,
                                        impl="cuda")
    want = ops.chunked_prefill_attention(q, k, v, table, off, kv,
                                         impl="reference")
    torch.cuda.synchronize()
    assert chunked_prefill.launches == before + 1
    assert torch.all(got[1, lens[1] - 128:] == 0)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hk,D,P,pps", [
    (3, 3, 1, 24, 8, 12),        # smoke smollm
    (8, 9, 3, 64, 16, 32),       # full-width smollm
])
def test_paged_decode_kernel_matches_plain(cuda, B, H, Hk, D, P, pps, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    k, v, table = _scene(gen, cuda, B, Hk, D, P, pps, dtype)
    q = torch.randn(B, H, D, generator=gen, device=cuda).to(dtype)
    lens = [0] + [(11 + 29 * b) % (P * pps) + 1 for b in range(1, B)]
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    poisoned = table.clone()
    for b, n in enumerate(lens):
        poisoned[b, -(-n // P):] = k.shape[0] * 13 + b
    before = paged_attention.paged_decode_launches
    got = ops.paged_decode_attention(q, k, v, poisoned, sl, impl="cuda")
    want = ops.paged_decode_attention(q, k, v, table, sl, impl="reference")
    torch.cuda.synchronize()
    assert paged_attention.paged_decode_launches == before + 1
    assert torch.all(got[0] == 0)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _split_lens(B, Hk, P, pps, longest):
    """Lengths on, one past and one before the edges of the plan's runs,
    mid-run, the longest, and 0 (as chip_smoke's split checks)."""
    steps = min(pps, 1 << (-(-longest // P) - 1).bit_length())  # the trim
    edge = paged_attention.split_plan(B, Hk, steps, P)[0] * P
    picks = [longest, edge, edge + 1, 3 * edge - 1, 2 * edge + edge // 2,
             0, min(5 * edge, P * pps - 1), 7]
    return [min(n, P * pps - 1) for n in picks[:B]]


# Both decode kernels where their page splits matter: 128-page tables
# with lengths up to 2,047 on, past and before a run's edge and mid-run,
# the 32-q-head layout, and a batch of empty slots but one; softcap 30,
# poisoned table tails. Each output against the plain version and the
# split-order plain version, and two calls bit-identical.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False], ids=["batched", "paged"])
@pytest.mark.parametrize("B,H,Hk,D,P,pps,lens", [
    (8, 9, 3, 64, 16, 128, _split_lens(8, 3, 16, 128, 2047)),
    (4, 32, 8, 128, 16, 64, _split_lens(4, 8, 16, 64, 1023)),
    (8, 9, 3, 64, 16, 32, [0, 0, 0, 0, 0, 300, 0, 0]),
])
def test_decode_kernels_at_split_edges(cuda, B, H, Hk, D, P, pps, lens, fused,
                                       dtype):
    gen = torch.Generator(device=cuda).manual_seed(10)
    k, v, table = _scene(gen, cuda, B, Hk, D, P, pps, dtype)
    q = torch.randn(B, H, D, generator=gen, device=cuda).to(dtype)
    kn = torch.randn(B, Hk, D, generator=gen, device=cuda).to(dtype)
    vn = torch.randn(B, Hk, D, generator=gen, device=cuda).to(dtype)
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    poisoned = table.clone()
    for b, n in enumerate(lens):
        poisoned[b, -(-n // P):] = k.shape[0] * 13 + b
    # the batched kernel's page loop trimmed as the engine trims it
    needed = max(1, -(-max(lens) // P))
    steps = min(pps, 1 << (needed - 1).bit_length()) if fused else pps

    def run(t, impl):
        if fused:
            return ops.batched_paged_decode_attention(
                q, k, v, t, sl, kn, vn, max_pages=steps, logit_softcap=30.0,
                impl=impl)
        return ops.paged_decode_attention(q, k, v, t, sl, logit_softcap=30.0,
                                          impl=impl)

    counter = "launches" if fused else "paged_decode_launches"
    before = getattr(paged_attention, counter)
    got, again = run(poisoned, "cuda"), run(poisoned, "cuda")
    want = run(table, "reference")
    per, _ = paged_attention.split_plan(B, Hk, steps, P)
    split = ref.paged_decode_split_ref(
        q, k, v, table, sl, *((kn, vn) if fused else ()),
        pages_per_split=per, n_page_steps=steps, logit_softcap=30.0)
    torch.cuda.synchronize()
    assert getattr(paged_attention, counter) == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(got.float(), split.float(), **TOL[dtype])
    if not fused:
        assert not got[sl == 0].any()
    assert not any(t.any() for t in paged_attention._tickets.values())


def _ssd_inputs(gen, dev, B, L, H, G, P, N, dtype):
    x = torch.randn(B, L, H, P, generator=gen, device=dev) * 0.5
    a = -torch.randn(B, L, H, generator=gen, device=dev).abs() * 0.1
    b = torch.randn(B, L, G, N, generator=gen, device=dev) * 0.5
    c = torch.randn(B, L, G, N, generator=gen, device=dev) * 0.5
    return [t.to(dtype) for t in (x, a, b, c)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,G,P,N,Q", [
    (1, 128, 4, 1, 16, 16, 32),      # the JAX test shapes
    (2, 256, 8, 2, 32, 64, 64),
    (1, 64, 2, 1, 64, 128, 64),
    (1, 100, 8, 1, 16, 16, 32),      # smoke mamba2, ragged last chunk
    (2, 40, 4, 2, 16, 32, 64),       # L < chunk
    (1, 1000, 80, 1, 64, 128, 256),  # mamba2-2.7b, ragged
    (1, 512, 64, 1, 64, 64, 256),    # zamba2
    (2, 250, 8, 2, 32, 256, 100),    # N 256; chunk 100, not a multiple of 16
    (1, 1024, 8, 2, 16, 12, 64),     # L = 16 chunks; N 12 pads to 16
    (2, 65, 4, 4, 128, 4, 16),       # N 4, H / G 1, L = 4 chunks + 1
])
def test_ssd_kernel_matches_plain(cuda, B, L, H, G, P, N, Q, dtype):
    """Against ref.ssd_chunked and the kernel's stages in plain form
    (ref.ssd_chunked_pieces); two calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, a, b, c = _ssd_inputs(gen, cuda, B, L, H, G, P, N, dtype)
    before = ssd_scan.launches
    got = ops.ssd(x, a, b, c, chunk=Q, impl="cuda")
    again = ops.ssd(x, a, b, c, chunk=Q, impl="cuda")
    want = ops.ssd(x, a, b, c, chunk=Q, impl="reference")
    pieces = ref.ssd_chunked_pieces(x, a, b, c, chunk=Q)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 2
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, again)
    for oracle in (want, pieces):
        tol = dict(TOL[dtype])
        if dtype == torch.float32:
            tol["atol"] = max(tol["atol"], 1e-5 * oracle.abs().max().item())
        torch.testing.assert_close(got.float(), oracle.float(), **tol)


def _grads(fn, inputs, r):
    ins = [t.clone().requires_grad_() for t in inputs]
    out = fn(*ins)
    return out, torch.autograd.grad(out, ins, r)


def test_ssd_kernel_gradients_match_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    inputs = _ssd_inputs(gen, cuda, 2, 200, 8, 2, 32, 64, torch.float32)
    r = torch.randn(inputs[0].shape, generator=gen, device=cuda)
    before = ssd_scan.launches
    yk, gk = _grads(lambda *t: ops.ssd(*t, chunk=64, impl="cuda"), inputs, r)
    yp, gp = _grads(lambda *t: ops.ssd(*t, chunk=64, impl="reference"),
                    inputs, r)
    assert ssd_scan.launches == before + 1 and yk.grad_fn is not None
    for got, want in zip(gk, gp):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,L,kw", [
    (2, 64, dict(window=40)),
    (8, 512, dict()),                # the dense trainer's, smollm-135m
])
def test_flash_kernel_gradients_match_plain(cuda, B, L, kw):
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(s, generator=gen, device=cuda)
               for s in ((B, L, 9, 64), (B, L, 3, 64), (B, L, 3, 64)))
    r = torch.randn(q.shape, generator=gen, device=cuda)
    before = flash_attention.launches
    yk, gk = _grads(lambda *t: ops.attention(*t, impl="cuda", **kw),
                    (q, k, v), r)
    yp, gp = _grads(lambda *t: ops.attention(*t, impl="reference", **kw),
                    (q, k, v), r)
    assert flash_attention.launches == before + 1 and yk.grad_fn is not None
    for got, want in zip(gk, gp):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,seq", [("mamba2-2.7b", 100),
                                      ("smollm-135m", 64)])
def test_train_step_on_cuda(cuda, arch, seq):
    """Two smoke-size train steps on the card: the kernels run twice per
    layer and step (forward, and its recompute under remat), the loss
    and the grad norm are finite, and the params move."""
    cfg = smoke_config(arch)
    params = get_api(cfg).init(cfg, torch.Generator(device=cuda).manual_seed(0),
                               device=cuda)
    opt = Optimizer(OptimizerConfig(warmup_steps=1))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    gen = torch.Generator(device=cuda).manual_seed(7)
    counter = (ssd_scan, "launches") if cfg.family == "ssm" else \
        (flash_attention, "launches")
    before = getattr(*counter)
    w0 = params["embed"]["table"].detach().clone()
    for _ in range(2):
        toks = torch.randint(0, cfg.vocab, (2, seq + 1), generator=gen,
                             device=cuda)
        params, state, m = step(params, state, {"tokens": toks[:, :-1],
                                                "labels": toks[:, 1:]})
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    torch.cuda.synchronize()
    assert getattr(*counter) - before == 2 * 2 * cfg.n_layers
    assert not torch.equal(params["embed"]["table"], w0)


def test_pd_extract_and_inject_bit_exact_on_the_card(cuda):
    """A P/D handoff between two engines on the card: the payload is a
    copy of the source's pages (on the card), injection writes exactly
    it into other pages of the destination, and one decode step of the
    sequence there gives the source's logits bit for bit."""
    cfg = smoke_config("smollm-135m")
    params = get_api(cfg).init(cfg, torch.Generator().manual_seed(0),
                               device=cuda)
    ecfg = EngineConfig(n_slots=2, max_len=96, prompt_buckets=(32,),
                        paged=True, page_size=8, chunk_prefill_tokens=16)
    src, dst = (ServingEngine(cfg, params, DriftScheduler("fifo"), ecfg,
                              device=cuda) for _ in range(2))
    gen = WorkloadGenerator(GeneratorConfig(
        total_requests=1, calibration_requests=1, max_tokens=16, seed=3))
    (t, req), = gen.plan(seed=3).calibration
    got = {}

    def hook(slot, r, now):
        pages = list(src.ledger.table(slot))
        payload = src.extract_sequence(slot)
        assert payload["k"].device == cuda
        for i, p in enumerate(pages):
            assert torch.equal(payload["k"][:, i], src.pool.k[:, p])
            assert torch.equal(payload["v"][:, i], src.pool.v[:, p])
        got.update(payload=payload, pages=pages)
        return True
    src.handoff_hook = hook
    src.sched.submit(req, t)
    before = chunked_prefill.launches
    now = 0.0
    while not got:
        src.step(now)
        now += 1.0
    assert chunked_prefill.launches - before == \
        cfg.n_layers * src.n_prefill_launches > 0
    payload = got["payload"]

    dst.alloc.alloc_raw(3)            # the injected pages differ
    dst.accept_handoff(req, payload)
    assert dst.sched.dispatch(now) is req
    slot = dst.free_slots()[0]
    dst._admit_prefilled(req, slot, dst.pop_pending_injection(req.req_id),
                         now)
    pages = dst.ledger.table(slot)
    assert min(pages) >= 3
    assert torch.equal(dst.pool.k[:, pages], payload["k"])
    assert torch.equal(dst.pool.v[:, pages], payload["v"])

    def step(eng, pages):
        table = torch.full((1, eng.alloc.pages_per_seq), eng.pool.n_pages - 1,
                           dtype=torch.int32)
        table[0, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
        return transformer.decode_step_paged(
            cfg, params, {"k": eng.pool.k, "v": eng.pool.v},
            torch.tensor([payload["last_token"]], device=cuda),
            table.to(cuda),
            torch.tensor([payload["seq_len"]], dtype=torch.int32,
                         device=cuda),
            max_pages=eng.alloc.pages_per_seq)
    before = paged_attention.launches
    want, logits = step(src, got["pages"]), step(dst, pages)
    torch.cuda.synchronize()
    assert paged_attention.launches - before == 2 * cfg.n_layers
    assert torch.equal(logits, want)
