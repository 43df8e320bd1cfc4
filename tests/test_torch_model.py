"""The port's dense layers and both transformer serving paths against
JAX.

Weights come from the JAX ``transformer.init(PRNGKey(0))`` on
``smoke_config("smollm-135m")`` (and ``"h2o-danube-1.8b"``, window 16,
for the sliding-window ring) and reach the port through
``bridge.params_from_numpy``; other inputs are made with numpy from a
seed. JAX runs on the CPU with its kernels through the jnp oracles
(``impl='auto'`` off-TPU); the port runs on the CPU with the plain
kernel versions. The slot-ring tests compare the whole caches (K, V,
lens and the int8 scales), not only the logits.

Tolerances: float32 ``atol=rtol=1e-5`` on layers and 1e-4 on logits
(two layers of the same math summed in another order); bfloat16
``atol=rtol=5e-2`` on logits of magnitude ~1 (activations round to bf16
after every op, at different points in the two frameworks).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as jl
from repro.models import transformer as jtr
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.models.steps import sample_logits

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(dtype, arch="smollm-135m"):
    return (jax_smoke_config(arch).replace(dtype=dtype),
            smoke_config(arch).replace(dtype=dtype))


@functools.lru_cache(maxsize=None)
def _params(dtype, arch="smollm-135m"):
    """(jax cfg, port cfg, jax params, port params); read-only in tests."""
    cfg_j, cfg_t = _cfgs(dtype, arch)
    pj = jtr.init(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(cfg_t, jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfg_j, cfg_t, pj, pt


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.float().numpy()


def test_bridge_keeps_layouts_and_bf16_bits():
    cfg_j, cfg_t, pj, pt = _params("bfloat16")
    wq = pt["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert tuple(wq.shape) == (cfg_t.n_layers, cfg_t.d_model,
                               cfg_t.n_heads, cfg_t.d_head)
    assert tuple(pt["layers"]["attn"]["wo"].shape) == (
        cfg_t.n_layers, cfg_t.n_heads, cfg_t.d_head, cfg_t.d_model)
    assert tuple(pt["embed"]["table"].shape) == (cfg_t.vocab, cfg_t.d_model)
    np.testing.assert_array_equal(
        _t(pt["embed"]["table"]), _np(pj["embed"]["table"]))


def test_port_init_layouts():
    cfg = smoke_config("smollm-135m")
    params = ttr.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, _, pj, _ = _params("bfloat16")
    shapes_t = {k: tuple(v.shape) for k, v in params["layers"]["attn"].items()}
    shapes_j = {k: tuple(v.shape) for k, v in pj["layers"]["attn"].items()}
    assert shapes_t == shapes_j
    assert params["embed"]["table"].dtype == torch.bfloat16
    std = params["layers"]["mlp"]["w1"].float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 24), dtype=np.float32)
    scale = rng.standard_normal((24,), dtype=np.float32) * 0.1
    np.testing.assert_allclose(
        _t(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))),
        _np(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale))), **LAYER_TOL)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        _t(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)),
        _np(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        **LAYER_TOL)


def test_mlp_qkv_embed_unembed():
    cfg_j, cfg_t, pj, pt = _params("float32")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, cfg_t.d_model), dtype=np.float32)
    lj = jax.tree_util.tree_map(lambda a: a[0], pj["layers"])
    lt = ttr.layer_params(pt, 0)
    np.testing.assert_allclose(
        _t(tl.mlp_block(cfg_t, lt["mlp"], torch.from_numpy(x))),
        _np(jl.mlp_block(cfg_j, lj["mlp"], jnp.asarray(x))), **LAYER_TOL)
    for got, want in zip(tl.qkv_project(lt["attn"], torch.from_numpy(x)),
                         jl.qkv_project(lj["attn"], jnp.asarray(x))):
        np.testing.assert_allclose(_t(got), _np(want), **LAYER_TOL)
    toks = rng.integers(0, cfg_t.vocab, size=(2, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        _t(tl.embed(cfg_t, pt["embed"], torch.from_numpy(toks))),
        _np(jl.embed(cfg_j, pj["embed"], jnp.asarray(toks))))
    capped_j, capped_t = (cfg_j.replace(logit_softcap=3.0),
                          cfg_t.replace(logit_softcap=3.0))
    for cj, ct in ((cfg_j, cfg_t), (capped_j, capped_t)):
        np.testing.assert_allclose(
            _t(tl.unembed(ct, pt["lm_head"], torch.from_numpy(x))),
            _np(jl.unembed(cj, pj["lm_head"], jnp.asarray(x))), **LAYER_TOL)


def test_sample_logits_greedy_takes_first_tied_max():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 0.0, 5.0]])
    assert sample_logits(logits, None).tolist() == [1, 0]
    got = np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1))
    assert got.tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    draws = sample_logits(torch.zeros(64, 4), gen, temperature=1.0)
    assert draws.min() >= 0 and draws.max() <= 3 and len(set(draws.tolist())) > 1


def _scene(cfg, rng, B, pps, n_pages, page):
    """A pool with random resident K/V and non-overlapping page tables
    (page n_pages - 1 is the scratch page, never in a table)."""
    shape = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.d_head)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    table = rng.permutation(n_pages - 1)[:B * pps].reshape(B, pps)
    return k, v, table.astype(np.int32)


def _pools(k, v, dtype):
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    return ({"k": jnp.asarray(k).astype(jd), "v": jnp.asarray(v).astype(jd)},
            {"k": torch.tensor(k, dtype=td), "v": torch.tensor(v, dtype=td)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_paged_matches_jax(dtype):
    cfg_j, cfg_t, pj, pt = _params(dtype)
    rng = np.random.default_rng(2)
    B, page, pps, n_pages = 3, 8, 6, 24
    k, v, table = _scene(cfg_t, rng, B, pps, n_pages, page)
    lens = np.array([7, 16, 0], np.int32)        # mid-page, boundary, inactive
    table[2, :] = n_pages - 1                     # inactive slot -> scratch
    toks = rng.integers(0, cfg_t.vocab, size=(B,)).astype(np.int32)
    pool_j, pool_t = _pools(k, v, dtype)
    logits_j, pool_j = jtr.decode_step_paged(
        cfg_j, pj, pool_j, jnp.asarray(toks), jnp.asarray(table),
        jnp.asarray(lens), max_pages=4)
    logits_t = ttr.decode_step_paged(
        cfg_t, pt, pool_t, torch.from_numpy(toks), torch.from_numpy(table),
        torch.from_numpy(lens), max_pages=4)
    np.testing.assert_allclose(_t(logits_t), _np(logits_j), **TOL[dtype])
    for name in ("k", "v"):                       # the in-place scatter
        np.testing.assert_allclose(_t(pool_t[name][:, :-1]),
                                   _np(pool_j[name][:, :-1]), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,start", [(16, 0), (8, 13), (1, 31)])
def test_prefill_chunk_paged_matches_jax(dtype, chunk, start):
    cfg_j, cfg_t, pj, pt = _params(dtype)
    rng = np.random.default_rng(3)
    B, page, pps, n_pages = 2, 8, 6, 16
    k, v, table = _scene(cfg_t, rng, B, pps, n_pages, page)
    toks = rng.integers(0, cfg_t.vocab, size=(B, chunk)).astype(np.int32)
    q_off = np.array([start, max(0, start - 5)], np.int32)
    pool_j, pool_t = _pools(k, v, dtype)
    logits_j, pool_j = jtr.prefill_chunk_paged(
        cfg_j, pj, pool_j, jnp.asarray(toks), jnp.asarray(table),
        jnp.asarray(q_off))
    logits_t = ttr.prefill_chunk_paged(
        cfg_t, pt, pool_t, torch.from_numpy(toks), torch.from_numpy(table),
        torch.from_numpy(q_off))
    np.testing.assert_allclose(_t(logits_t), _np(logits_j), **TOL[dtype])
    for name in ("k", "v"):
        np.testing.assert_allclose(_t(pool_t[name]), _np(pool_j[name]),
                                   **TOL[dtype])


def test_prefill_then_decode_greedy_tokens_match_jax():
    """Prefill a prompt chunk by chunk, then decode greedily: the port
    emits JAX's token at every step (float32)."""
    cfg_j, cfg_t, pj, pt = _params("float32")
    rng = np.random.default_rng(4)
    page, n_pages, T = 8, 9, 24
    shape = (cfg_t.n_layers, n_pages, page, cfg_t.n_kv_heads, cfg_t.d_head)
    zeros = np.zeros(shape, np.float32)
    pool_j, pool_t = _pools(zeros, zeros, "float32")
    table = np.arange(8, dtype=np.int32)[None]
    prompt = rng.integers(1, cfg_t.vocab, size=(1, T)).astype(np.int32)
    prefill_j = jax.jit(functools.partial(jtr.prefill_chunk_paged, cfg_j))
    decode_j = jax.jit(functools.partial(jtr.decode_step_paged, cfg_j))
    for s in range(0, T, 12):
        e = min(s + 12, T)
        lj, pool_j = prefill_j(
            pj, pool_j, jnp.asarray(prompt[:, s:e]),
            jnp.asarray(table), jnp.asarray([s], jnp.int32))
        lt = ttr.prefill_chunk_paged(
            cfg_t, pt, pool_t, torch.from_numpy(prompt[:, s:e]),
            torch.from_numpy(table), torch.tensor([s], dtype=torch.int32))
    tok_j, tok_t = int(jnp.argmax(lj[0])), int(sample_logits(lt, None)[0])
    assert tok_j == tok_t
    for n in range(T, T + 12):
        lens = np.array([n], np.int32)
        lj, pool_j = decode_j(
            pj, pool_j, jnp.asarray([tok_j], jnp.int32),
            jnp.asarray(table), jnp.asarray(lens))
        lt = ttr.decode_step_paged(
            cfg_t, pt, pool_t, torch.tensor([tok_t]), torch.from_numpy(table),
            torch.from_numpy(lens))
        tok_j, tok_t = int(jnp.argmax(lj[0])), int(sample_logits(lt, None)[0])
        assert tok_j == tok_t, n


def _close_cache(cache_t, cache_j, dtype):
    """Every leaf of the port's contiguous cache against JAX's."""
    assert set(cache_t) == set(cache_j)
    np.testing.assert_array_equal(cache_t["lens"].numpy(),
                                  np.asarray(cache_j["lens"]))
    for name in ("k", "v"):
        got, want = cache_t[name], cache_j[name]
        assert tuple(got.shape) == want.shape
        if got.dtype == torch.int8:
            st = cache_t[name + "_scale"].numpy()
            sj = np.asarray(cache_j[name + "_scale"])
            np.testing.assert_allclose(st, sj, **TOL[dtype])
            codes_t = got.numpy().astype(np.int32)
            codes_j = np.asarray(want, np.int32)
            # dequantised values within the dtype's tolerance plus one
            # code step: inputs that agree to the tolerance may round
            # to neighbouring codes
            deq_t, deq_j = codes_t * st[..., None], codes_j * sj[..., None]
            slack = (TOL[dtype]["atol"] + TOL[dtype]["rtol"] * np.abs(deq_j)
                     + sj[..., None])
            assert (np.abs(deq_t - deq_j) <= slack).all(), name
            if dtype == "float32":   # f32 inputs agree to ~1e-6
                assert (codes_t == codes_j).mean() > 0.99, name
        else:
            np.testing.assert_allclose(_t(got), _np(want), **TOL[dtype])


def _clone_cache(cache):
    return {k: v.clone() for k, v in cache.items()}


def _cache_from_jax(cache_j, like):
    """JAX's cache as the port's, each leaf in the dtype of ``like``'s."""
    return {name: tensor_from_numpy(np.asarray(cache_j[name]), "cpu",
                                    dtype=like[name].dtype)
            for name in like}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch,L,max_len,steps", [
    ("smollm-135m", 10, 32, 4),       # L < S, no window
    ("h2o-danube-1.8b", 24, 32, 4),   # L > S = 16: the ring roll
    ("h2o-danube-1.8b", 12, 32, 8),   # decode crosses the window
])
def test_prefill_decode_step_match_jax(arch, L, max_len, steps, kv_dtype,
                                       dtype):
    cfg_j, cfg_t, pj, pt = _params(dtype, arch)
    cfg_j = cfg_j.replace(kv_dtype=kv_dtype)
    cfg_t = cfg_t.replace(kv_dtype=kv_dtype)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg_t.vocab, size=(2, L + steps)).astype(np.int32)
    lj, cache_j = jtr.prefill(cfg_j, pj, jnp.asarray(toks[:, :L]),
                              max_len=max_len)
    lt, cache_t = ttr.prefill(cfg_t, pt, torch.from_numpy(toks[:, :L]),
                              max_len=max_len)
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL[dtype])
    _close_cache(cache_t, cache_j, dtype)
    for i in range(steps):
        pos = L + i
        # each step starts from a copy of JAX's cache: the two prefills
        # may round an f32 value on a rounding edge to neighbouring int8
        # codes (one code step, allowed above), and the logits carry no
        # such slack; what the step writes is compared with the same
        # one-code slack
        cache_t = _cache_from_jax(cache_j, cache_t)
        lj, cache_j = jtr.decode_step(cfg_j, pj, cache_j,
                                      jnp.asarray(toks[:, pos]),
                                      jnp.asarray(pos, jnp.int32))
        lt, cache_t = ttr.decode_step(cfg_t, pt, cache_t,
                                      torch.from_numpy(toks[:, pos]), pos)
        np.testing.assert_allclose(_t(lt), _np(lj), **TOL[dtype],
                                   err_msg=f"decode step {i}")
        _close_cache(cache_t, cache_j, dtype)


@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-1.8b"])
def test_per_slot_positions(arch):
    """A per-slot ``pos`` vector of equal depths gives the scalar-pos
    step, and slots at different depths match JAX's vector-pos step
    (ring slot ``pos % S`` each)."""
    cfg_j, cfg_t, pj, pt = _params("float32", arch)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg_t.vocab, size=(2, 21)).astype(np.int32)
    _, cache_j = jtr.prefill(cfg_j, pj, jnp.asarray(toks[:, :20]), max_len=32)
    _, cache_t = ttr.prefill(cfg_t, pt, torch.from_numpy(toks[:, :20]),
                             max_len=32)
    nxt = torch.from_numpy(toks[:, 20])
    l_scalar, c_scalar = ttr.decode_step(cfg_t, pt, _clone_cache(cache_t),
                                         nxt, 20)
    l_vec, c_vec = ttr.decode_step(cfg_t, pt, _clone_cache(cache_t), nxt,
                                   torch.full((2,), 20, dtype=torch.int32))
    torch.testing.assert_close(l_vec, l_scalar, atol=1e-5, rtol=1e-5)
    for name in ("k", "v", "lens"):
        torch.testing.assert_close(c_vec[name], c_scalar[name])
    pos = np.array([20, 13], np.int32)
    lj, cache_j = jtr.decode_step(cfg_j, pj, cache_j, jnp.asarray(toks[:, 20]),
                                  jnp.asarray(pos))
    lt, cache_t = ttr.decode_step(cfg_t, pt, cache_t, nxt,
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL["float32"])
    _close_cache(cache_t, cache_j, "float32")


@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-1.8b"])
def test_init_cache_matches_jax(arch):
    """Same shapes, dtypes and zeros; int8 holds 1/2 + 4/(2 hd) of the
    bf16 bytes, as in the JAX cache."""
    cfg_j, cfg_t = _cfgs("bfloat16", arch)
    for kv in ("bfloat16", "int8"):
        cj = jtr.init_cache(cfg_j.replace(kv_dtype=kv), 3, 40)
        ct = ttr.init_cache(cfg_t.replace(kv_dtype=kv), 3, 40, device="cpu")
        assert set(ct) == set(cj)
        for name, t in ct.items():
            assert tuple(t.shape) == cj[name].shape, name
            assert str(t.dtype).split(".")[-1] == str(cj[name].dtype), name
            assert not t.any()
    c16 = ttr.init_cache(cfg_t, 2, 64, device="cpu")
    c8 = ttr.init_cache(cfg_t.replace(kv_dtype="int8"), 2, 64, device="cpu")
    b16 = sum(c16[k].nbytes for k in ("k", "v"))
    b8 = sum(c8[k].nbytes for k in ("k", "v", "k_scale", "v_scale"))
    assert b8 == (0.5 + 4 / (2 * cfg_t.d_head)) * b16
    assert ttr.cache_size(cfg_t, 40) == (
        16 if cfg_t.sliding_window else 40) == jtr.cache_size(cfg_j, 40)


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 8, 32), dtype=np.float32) * 3
    qj, sj = jl.quantize_kv(jnp.asarray(x))
    qt, st = tl.quantize_kv(torch.from_numpy(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **LAYER_TOL)
    np.testing.assert_allclose(tl.dequantize_kv(qt, st).numpy(),
                               np.asarray(jl.dequantize_kv(qj, sj)),
                               **LAYER_TOL)


def test_other_families_raise():
    """The transformer runs the dense, moe and vlm families; an unknown
    family raises."""
    cfg = smoke_config("smollm-135m").replace(family="rnn")
    with pytest.raises(ValueError, match="'rnn'"):
        ttr.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="'rnn'"):
        ttr.forward(cfg, _params("float32")[3],
                    torch.zeros(1, 4, dtype=torch.long))


def test_tensor_from_numpy_float32_roundtrip():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tensor_from_numpy(a, device="cpu")
    assert t.dtype == torch.float32 and t.tolist() == a.tolist()
