"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA GPU and nvcc: they build ``kernels/csrc`` and
launch each kernel through its wrapper. Without CUDA they skip, unless
``REPRO_TORCH_REQUIRE_CUDA=1`` says the run is on the GPU machine, where
a missing GPU is a failure:

    REPRO_TORCH_REQUIRE_CUDA=1 PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: float32 ``atol=rtol=2e-5``; bfloat16 ``atol=rtol=1e-2``
(both versions sum in float32; they differ in order only, so bf16
outputs are at most about one bf16 ulp apart).
"""

import os

import pytest
import torch

from repro_torch.kernels import (chunked_prefill, flash_attention, ops,
                                 paged_attention)

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
