"""The port's SSD scan (Mamba-2) and the autograd wrappers of its
training-path kernels, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs the Pallas ``ssd_scan`` in interpret mode (as
``tests/test_kernels.py`` does) and ``ref.ssd_chunked`` with its final
state on ragged lengths; the port side runs its plain versions, which
``ops.ssd`` takes for CPU tensors (the CUDA kernel is held against them
on the card by ``test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances: float32 ``atol=rtol=1e-4`` (two chunked float32 scans of
the same math, sums of up to a chunk of O(1) terms in another order, as
``tests/test_kernels.py`` allows the Pallas kernel against its oracle);
bfloat16 ``atol=rtol=3e-2`` (outputs round to bf16 after float32 sums
that differ in order). Gradients of the autograd Functions are held to
``atol=rtol=1e-6``: forward and backward are the same float32 plain
code on both sides, so only the order of gradient accumulation differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels import ssd_scan as jax_ssd_scan
from repro_torch.kernels import flash_attention, ops, ref, ssd_scan

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
GRAD_TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs(seed, B, L, H, G, P, N, dtype="float32"):
    """(jax, torch) pairs of x, a, b, c as tests/test_kernels.py scales
    them: x, b, c ~ 0.5 N(0, 1) and a = -0.1 |N(0, 1)|."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((B, L, H, P), dtype=np.float32)
    a = -0.1 * np.abs(rng.standard_normal((B, L, H), dtype=np.float32))
    b = 0.5 * rng.standard_normal((B, L, G, N), dtype=np.float32)
    c = 0.5 * rng.standard_normal((B, L, G, N), dtype=np.float32)
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(t).astype(jd) for t in (x, a, b, c)],
            [torch.from_numpy(t).to(td) for t in (x, a, b, c)])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,G,P,N,chunk", [
    (1, 128, 4, 1, 16, 16, 32),
    (2, 256, 8, 2, 32, 64, 64),
    (1, 64, 2, 1, 64, 128, 64),
])
def test_ssd_matches_pallas_interpret(B, L, H, G, P, N, chunk, dtype):
    """The JAX test shapes: the port's chunked and naive forms against
    the Pallas kernel body in interpret mode."""
    (xj, aj, bj, cj), (xt, at, bt, ct) = _inputs(7, B, L, H, G, P, N, dtype)
    want = jax_ssd_scan(xj, aj, bj, cj, chunk=chunk, interpret=True)
    got = ops.ssd(xt, at, bt, ct, chunk=chunk)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got, want, TOL[dtype])
    _close(ref.ssd_naive(xt, at, bt, ct), want, TOL[dtype])


@pytest.mark.parametrize("B,L,H,G,P,N,chunk", [
    (2, 192, 4, 2, 16, 32, 64),     # three whole chunks
    (1, 100, 4, 1, 16, 16, 32),     # ragged: 3 chunks + 4 tokens
    (2, 200, 4, 2, 16, 32, 64),     # ragged: 3 chunks + 8 tokens
    (1, 20, 2, 1, 16, 16, 32),      # chunk > L acts as chunk = L
])
def test_ssd_chunked_matches_jax_with_final_state(B, L, H, G, P, N, chunk):
    (xj, aj, bj, cj), (xt, at, bt, ct) = _inputs(8, B, L, H, G, P, N)
    yj, sj = jax_ref.ssd_chunked(xj, aj, bj, cj, chunk=chunk,
                                 return_final_state=True)
    yt, st = ref.ssd_chunked(xt, at, bt, ct, chunk=chunk,
                             return_final_state=True)
    assert st.dtype == torch.float32 and st.shape == (B, H, P, N)
    _close(yt, yj, TOL["float32"])
    _close(st, sj, TOL["float32"])
    _close(yt, jax_ref.ssd_naive(xj, aj, bj, cj), TOL["float32"])


def test_ops_ssd_dispatch_on_cpu():
    """CPU tensors take the plain version (no kernel launch), impl='cuda'
    raises, and gradients reach x, a, b and c."""
    _, (xt, at, bt, ct) = _inputs(9, 1, 96, 4, 2, 16, 16)
    before = ssd_scan.launches
    ins = [t.clone().requires_grad_() for t in (xt, at, bt, ct)]
    y = ops.ssd(*ins, chunk=32)
    torch.testing.assert_close(y, ref.ssd_chunked(xt, at, bt, ct, chunk=32),
                               atol=0, rtol=0)
    torch.testing.assert_close(ops.ssd(xt, at, bt, ct, chunk=32,
                                       impl="reference"), y.detach(),
                               atol=0, rtol=0)
    grads = torch.autograd.grad(y.square().sum(), ins)
    assert all(g is not None and g.abs().sum() > 0 for g in grads)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(xt, at, bt, ct, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.ssd(xt, at, bt, ct, impl="pallas")
    assert ssd_scan.launches == before


def test_ssd_wrapper_refuses_bad_shapes():
    _, (xt, at, bt, ct) = _inputs(10, 1, 16, 3, 2, 16, 16)
    with pytest.raises(ValueError, match="group"):
        ssd_scan.ssd_scan(xt, at, bt, ct)
    _, (xt, at, bt, ct) = _inputs(10, 1, 16, 4, 2, 16, 16)
    with pytest.raises(ValueError, match="match"):
        ssd_scan.ssd_scan(xt, at[:, :8], bt, ct)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan.ssd_scan(xt, at, bt, ct, chunk=0)


def _plain_grads(fn, inputs, seed):
    """Gradients of <fn(*inputs), r> for a fixed random r."""
    ins = [t.clone().requires_grad_() for t in inputs]
    out = fn(*ins)
    r = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(out.shape), dtype=np.float32))
    return out, torch.autograd.grad(out, ins, r)


def test_ssd_autograd_function_matches_plain_autograd(monkeypatch):
    """The Function's forward launches the kernel (here monkeypatched to
    the plain version) and its backward differentiates the plain version
    on the saved inputs: equal to plain autograd through the forward."""
    launched = []

    def fake_kernel(x, a, b, c, *, chunk):
        launched.append(chunk)
        return ref.ssd_chunked(x, a, b, c, chunk=chunk)

    monkeypatch.setattr(ops, "_ssd_cuda", fake_kernel)
    _, inputs = _inputs(11, 2, 100, 4, 2, 16, 32)
    y_f, g_f = _plain_grads(lambda *t: ops._SSDScan.apply(*t, 32), inputs, 1)
    y_p, g_p = _plain_grads(lambda *t: ref.ssd_chunked(*t, chunk=32),
                            inputs, 1)
    assert launched == [32]
    assert y_f.grad_fn is not None
    torch.testing.assert_close(y_f, y_p, atol=0, rtol=0)
    for got, want in zip(g_f, g_p):
        torch.testing.assert_close(got, want, **GRAD_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(window=12),
                                dict(logit_softcap=5.0, prefix_len=4)])
def test_flash_autograd_function_matches_plain_autograd(monkeypatch, kw):
    launched = []

    def fake_kernel(q, k, v, **kwargs):
        launched.append(kwargs)
        return ref.flash_attention_chunked(q, k, v, **kwargs)

    monkeypatch.setattr(ops, "_flash_cuda", fake_kernel)
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 24, 6, 16), (2, 24, 2, 16), (2, 24, 2, 16)))
    full = dict(causal=True, window=None, logit_softcap=None, prefix_len=0)
    full.update(kw)
    y_f, g_f = _plain_grads(
        lambda *t: ops._FlashAttention.apply(*t, *full.values()), (q, k, v), 2)
    y_p, g_p = _plain_grads(
        lambda *t: ref.flash_attention_chunked(*t, **full), (q, k, v), 2)
    assert launched == [full] and y_f.grad_fn is not None
    torch.testing.assert_close(y_f, y_p, atol=0, rtol=0)
    for got, want in zip(g_f, g_p):
        torch.testing.assert_close(got, want, **GRAD_TOL)


def test_attention_on_cpu_is_plain_and_differentiable():
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .requires_grad_() for s in ((1, 8, 4, 8), (1, 8, 2, 8),
                                            (1, 8, 2, 8)))
    before = flash_attention.launches
    out = ops.attention(q, k, v, window=4)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert flash_attention.launches == before
    assert all(g.abs().sum() > 0 for g in grads)
