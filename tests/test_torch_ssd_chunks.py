"""The SSD scan in the CUDA kernel's three stages, on the CPU.

``ref.ssd_chunk_states`` (each chunk's cumsum of the log decays and its
local state), ``ref.ssd_state_pass`` (the state carried into each chunk)
and ``ref.ssd_chunk_scan`` (each chunk's output from its own tokens and
the carried state) are the plain versions of the stages
``csrc/ssd_scan.cu`` launches. Here they are held, stage by stage and
composed (``ref.ssd_chunked_pieces``), against the JAX package's
``ref.ssd_chunked`` (its final state after each prefix of whole chunks
is the state carried into the next chunk) and against the Pallas kernel
in interpret mode, on ragged last chunks, ``L < chunk``,
``L = k chunk +- 1``, 16 chunks, ``G`` 1 and 2 with ``H / G`` 1 and 4,
and ``N`` 4. Also: the wrapper's scratch sizes and CUDA launch count
from Python ints, and that a CPU tensor still runs ``ref.ssd_chunked``.
Inputs are made with numpy from a seed.

Tolerances: against JAX, float32 ``atol=rtol=1e-4`` (two chunked
float32 scans of the same math, sums of up to a chunk of O(1) terms in
another order, as ``tests/test_torch_ssd.py`` allows); the stages
against the port's own ``ref.ssd_chunked`` ``atol=rtol=1e-5`` (the same
float32 einsums, C B^T formed per group instead of per head).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels import ssd_scan as jax_ssd_scan
from repro_torch.kernels import _build, ref, ssd_scan

JAX_TOL = dict(atol=1e-4, rtol=1e-4)
PORT_TOL = dict(atol=1e-5, rtol=1e-5)

SHAPES = [  # B, L, H, G, P, N, chunk
    (2, 100, 4, 1, 16, 16, 32),    # ragged: 3 chunks + 4; G 1, H / G 4
    (1, 20, 2, 2, 16, 8, 32),      # L < chunk; G 2, H / G 1
    (2, 63, 8, 2, 16, 16, 16),     # L = 4 chunks - 1; G 2, H / G 4
    (1, 65, 1, 1, 16, 4, 16),      # L = 4 chunks + 1; N 4; G 1, H / G 1
    (1, 256, 4, 1, 32, 8, 16),     # L = 16 chunks
    (2, 64, 2, 2, 16, 12, 16),     # whole chunks; N 12; G 2, H / G 1
]


def _inputs(seed, B, L, H, G, P, N):
    """numpy float32 x, a, b, c as tests/test_kernels.py scales them."""
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((B, L, H, P), dtype=np.float32),
            -0.1 * np.abs(rng.standard_normal((B, L, H), dtype=np.float32)),
            0.5 * rng.standard_normal((B, L, G, N), dtype=np.float32),
            0.5 * rng.standard_normal((B, L, G, N), dtype=np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("B,L,H,G,P,N,chunk", SHAPES)
def test_stages_match_jax_chunked(B, L, H, G, P, N, chunk):
    """Stage 1's cumsum is numpy's; the state carried into chunk k is
    JAX's final state after the first k chunks; the composed output is
    JAX's ``ssd_chunked`` and the port's."""
    arrays = _inputs(21, B, L, H, G, P, N)
    x, a, b, c = (torch.from_numpy(t) for t in arrays)
    xj, aj, bj, cj = (jnp.asarray(t) for t in arrays)
    Q = min(chunk, L)
    nc = -(-L // Q)

    acs, states = ref.ssd_chunk_states(x, a, b, chunk=Q)
    assert acs.shape == (B, nc, H, Q) and states.shape == (B, nc, H, P, N)
    a_pad = np.zeros((B, nc * Q, H), np.float32)
    a_pad[:, :L] = arrays[1]
    want_acs = np.cumsum(a_pad.reshape(B, nc, Q, H), axis=2).transpose(0, 1, 3, 2)
    _close(acs, want_acs, PORT_TOL)

    h_in, final = ref.ssd_state_pass(states, acs)
    assert h_in.shape == (B, nc, H, P, N) and not h_in[:, 0].any()
    for k in range(1, nc):
        _, sj = jax_ref.ssd_chunked(xj[:, :k * Q], aj[:, :k * Q], bj[:, :k * Q],
                                    cj[:, :k * Q], chunk=Q,
                                    return_final_state=True)
        _close(h_in[:, k], sj, JAX_TOL)
    yj, sj = jax_ref.ssd_chunked(xj, aj, bj, cj, chunk=chunk,
                                 return_final_state=True)
    _close(final, sj, JAX_TOL)

    y = ref.ssd_chunk_scan(x, b, c, acs, h_in)
    assert y.shape == (B, L, H, P) and y.dtype == torch.float32
    _close(y, yj, JAX_TOL)
    composed, final2 = ref.ssd_chunked_pieces(x, a, b, c, chunk=chunk,
                                              return_final_state=True)
    torch.testing.assert_close(composed, y, atol=0, rtol=0)
    torch.testing.assert_close(final2, final, atol=0, rtol=0)
    want, want_final = ref.ssd_chunked(x, a, b, c, chunk=chunk,
                                       return_final_state=True)
    torch.testing.assert_close(composed, want, **PORT_TOL)
    torch.testing.assert_close(final2, want_final, **PORT_TOL)


@pytest.mark.parametrize("B,L,H,G,P,N,chunk", [
    s for s in SHAPES if s[1] % s[6] == 0] + [(1, 128, 4, 1, 16, 16, 32)])
def test_pieces_match_pallas_interpret(B, L, H, G, P, N, chunk):
    """The composed stages against the Pallas kernel body in interpret
    mode (which takes whole chunks only)."""
    arrays = _inputs(22, B, L, H, G, P, N)
    want = jax_ssd_scan(*(jnp.asarray(t) for t in arrays), chunk=chunk,
                        interpret=True)
    got = ref.ssd_chunked_pieces(*(torch.from_numpy(t) for t in arrays),
                                 chunk=chunk)
    _close(got, want, JAX_TOL)


@pytest.mark.parametrize("B,L,H,G,P,N,chunk", SHAPES)
def test_scratch_sizes_match_the_stages(B, L, H, G, P, N, chunk):
    """The wrapper's float32 scratch holds stage 1's cumsums and every
    chunk's state but the last (the state pass turns them into the states
    carried out of each chunk), with a bf16 third part of each; one call
    is 3 CUDA launches, 2 without a state to carry."""
    arrays = _inputs(23, B, L, H, G, P, N)
    x, a, b, _ = (torch.from_numpy(t) for t in arrays)
    acs, states = ref.ssd_chunk_states(x, a, b, chunk=min(chunk, L))
    sizes = ssd_scan.scratch_sizes(B, L, H, P, N, chunk)
    carried = states[:, :-1].numel()
    assert sizes == {"states": carried + carried // 2, "lcs": acs.numel()}
    assert 4 * sizes["states"] == 4 * carried + 2 * carried
    nc = ssd_scan.n_chunks(L, chunk)
    assert nc == states.shape[1]
    assert ssd_scan.cuda_launches(L, chunk) == (3 if nc > 1 else 2)


@pytest.mark.parametrize("B,L,H,G,P,N,chunk", SHAPES)
def test_cpu_tensors_still_take_ssd_chunked(monkeypatch, B, L, H, G, P, N,
                                            chunk):
    """On CPU tensors the wrapper returns ``ref.ssd_chunked``'s bits and
    neither builds nor counts a kernel launch."""
    def no_build(*args, **kwargs):
        raise AssertionError("the CPU path reached the CUDA build")

    monkeypatch.setattr(_build, "load", no_build)
    x, a, b, c = (torch.from_numpy(t) for t in _inputs(24, B, L, H, G, P, N))
    before = ssd_scan.launches
    got = ssd_scan.ssd_scan(x, a, b, c, chunk=chunk)
    torch.testing.assert_close(got, ref.ssd_chunked(x, a, b, c, chunk=chunk),
                               atol=0, rtol=0)
    assert ssd_scan.launches == before
