"""The port's cells against JAX: the assigned shapes, each cell's inputs,
the abstract params, the prefill and serve steps, the roofline, and the
one-card dry run on the ``meta`` device.

JAX runs on the CPU with its kernels' jnp oracles; the port on the CPU
(the plain kernel versions) or on ``meta``. The step parity tests bridge
the JAX ``init(PRNGKey(0))`` weights of each family's smoke config in
float32 (``bridge.params_from_numpy``); prompts and stub inputs come
from ``numpy.random.default_rng``. Tolerance of logits-derived caches:
float32 ``atol=rtol=1e-4`` (two layers of the same math summed in
another order); greedy tokens must be equal.

``repro.launch.dryrun`` and ``repro.launch.roofline`` are never imported
here: they set ``XLA_FLAGS`` at import, which would change JAX's device
count for the rest of the worker. ``repro.launch.analysis`` is safe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cells_for as jax_cells_for
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import shape_applicable as jax_shape_applicable
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import analysis as jan
from repro.models import registry as jreg
from repro.models import steps as jsteps
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS, SHAPES, cells_for, get_config, \
    input_specs, shape_applicable, smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import analysis as tan
from repro_torch.launch import dryrun, mesh
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tl
from repro_torch.models import registry as treg
from repro_torch.models import steps as tsteps

# one arch of each of the six families
FAMILIES = {"dense": "smollm-135m", "moe": "grok-1-314b",
            "vlm": "paligemma-3b", "ssm": "mamba2-2.7b",
            "hybrid": "zamba2-1.2b", "encdec": "whisper-large-v3"}
ALL_CELLS = [(a, s.name) for a in ARCHS for s in cells_for(get_config(a))]
TOL = dict(atol=1e-4, rtol=1e-4)


def _leaves(tree, prefix=()):
    """{path: leaf} of a nested dict (``None`` leaves kept)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _sig(x):
    """(shape, dtype name) of a JAX ShapeDtypeStruct or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    return tuple(x.shape), jnp.dtype(x.dtype).name


# ---------------------------------------------------------------------------
# shapes, cells, input specs, abstract params
# ---------------------------------------------------------------------------

def test_shapes_and_cells_equal_jax():
    assert list(ARCHS) == list(JAX_ARCHS)
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind)
            for k, s in SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind)
         for k, s in JAX_SHAPES.items()}
    for arch in ARCHS:
        cfg, cfg_j = get_config(arch), jax_get_config(arch)
        assert [s.name for s in cells_for(cfg)] == \
            [s.name for s in jax_cells_for(cfg_j)]
        for name in SHAPES:
            assert shape_applicable(cfg, SHAPES[name]) == \
                jax_shape_applicable(cfg_j, JAX_SHAPES[name])
    assert len(ALL_CELLS) == 33


@pytest.mark.parametrize("arch,shape", ALL_CELLS)
def test_input_specs_equal_jax(arch, shape):
    got = _leaves(input_specs(get_config(arch), SHAPES[shape]))
    want = _leaves(jax_input_specs(jax_get_config(arch), JAX_SHAPES[shape]))
    assert set(got) == set(want)
    for path, leaf in want.items():
        if path == ("rng",):
            assert got[path] is None      # the greedy step's generator slot
            continue
        assert got[path].device.type == "meta", path
        assert _sig(got[path]) == _sig(leaf), path


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_jax_and_allocate_nothing(arch):
    got = _leaves(treg.abstract_params(get_config(arch)))
    want = _leaves(jreg.abstract_params(jax_get_config(arch)))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].device.type == "meta", path
        assert _sig(got[path]) == _sig(leaf), path


def test_meta_init_draws_nothing_and_real_draws_are_unchanged():
    gen = torch.Generator().manual_seed(3)
    w = tl.dense_init(gen, (4, 6), dtype=torch.float32, device="meta")
    e = tl.embed_init(gen, (5, 6), dtype=torch.bfloat16, device="meta")
    assert (w.device.type, w.dtype, tuple(w.shape)) == \
        ("meta", torch.float32, (4, 6))
    assert (e.device.type, e.dtype) == ("meta", torch.bfloat16)
    # the generator was not advanced by the meta calls
    got = tl.dense_init(gen, (4, 6), dtype=torch.float32, device="cpu")
    want = torch.randn((4, 6), generator=torch.Generator().manual_seed(3)) \
        * 4 ** -0.5
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the dispatch and the slot-ring write on meta
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_ops_on_meta_take_the_plain_version_under_auto():
    B, L, H, Hk, D = 2, 8, 4, 2, 16
    q, k = _meta(B, L, H, D), _meta(B, L, Hk, D)
    assert ops.attention(q, k, k).device.type == "meta"
    x = _meta(B, 64, 2, 8)
    out = ops.ssd(x, _meta(B, 64, 2), _meta(B, 64, 1, 4), _meta(B, 64, 1, 4),
                  chunk=32)
    assert out.device.type == "meta" and tuple(out.shape) == (B, 64, 2, 8)
    n_pages, page, pps = 6, 4, 3
    qd, kp = _meta(B, H, D), _meta(n_pages, page, Hk, D)
    table = torch.zeros((B, pps), dtype=torch.int32, device="meta")
    lens = torch.zeros((B,), dtype=torch.int32, device="meta")
    assert ops.paged_decode_attention(qd, kp, kp, table, lens
                                      ).device.type == "meta"
    assert ops.batched_paged_decode_attention(
        qd, kp, kp, table, lens, _meta(B, Hk, D), _meta(B, Hk, D)
    ).device.type == "meta"
    assert ops.chunked_prefill_attention(
        _meta(B, 4, H, D), kp, kp, table, lens, lens).device.type == "meta"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.attention(q, k, k, impl="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.paged_decode_attention(qd, kp, kp, table, lens, impl="cuda")


@pytest.mark.parametrize("pos", [5, [1, 7, 12]])
def test_slot_ring_write_lands_in_the_ring_slots(pos):
    """The decode write (an index_put, no host sync) puts each token's
    K/V at ``pos % S``, for one position or one per slot, and touches
    nothing else; on meta it runs."""
    cfg = smoke_config("smollm-135m").replace(dtype="float32")
    p = treg.get_api(cfg).init(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    lp = {k: v[0] for k, v in p["layers"]["attn"].items()}
    B, S = 3, 8
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, cfg.d_model), np.float32))
    k_cache = torch.from_numpy(
        rng.standard_normal((B, S, cfg.n_kv_heads, cfg.d_head), np.float32))
    v_cache = k_cache.clone() + 1
    k0, v0 = k_cache.clone(), v_cache.clone()
    posb = torch.as_tensor(pos).expand(B)
    _, k_new, v_new = tl.qkv_project(lp, x)
    k_new = tl.apply_rope(k_new, posb, cfg.rope_theta)
    tl.attention_decode(cfg, lp, x, k_cache, v_cache, torch.as_tensor(pos),
                        torch.full((B,), S))
    for b in range(B):
        slot = int(posb[b]) % S
        k0[b, slot], v0[b, slot] = k_new[b], v_new[b]
    assert torch.equal(k_cache, k0) and torch.equal(v_cache, v0)
    out = tl.attention_decode(
        cfg, {k: v.to("meta") for k, v in lp.items()}, x.to("meta"),
        k_cache.to("meta"), v_cache.to("meta"),
        torch.as_tensor(pos, device="meta"),
        torch.full((B,), S, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (B, cfg.d_model)


# ---------------------------------------------------------------------------
# prefill and serve steps against JAX
# ---------------------------------------------------------------------------

def _family_inputs(cfg, B, L, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, L), dtype=np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = 0.02 * rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _assert_caches_equal(got, want):
    want = _leaves(jax.tree_util.tree_map(np.asarray, want))
    got = _leaves(got)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].float().numpy(),
                                   w.astype(np.float32), err_msg=str(path),
                                   **TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_and_serve_steps_match_jax(family):
    arch = FAMILIES[family]
    cfg_j = jax_smoke_config(arch).replace(dtype="float32")
    cfg_t = smoke_config(arch).replace(dtype="float32")
    pj = jreg.get_api(cfg_j).init(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(cfg_t, jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    B, L = 2, 12
    max_len = cfg_t.prefix_len + L + 4
    raw = _family_inputs(cfg_t, B, L, seed=7)

    tok_j, cache_j = jsteps.make_prefill_step(cfg_j, max_len=max_len)(
        pj, {k: jnp.asarray(v) for k, v in raw.items()}, None)
    tok_t, cache_t = tsteps.make_prefill_step(cfg_t, max_len=max_len)(
        pt, {k: torch.from_numpy(v) for k, v in raw.items()}, None)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    _assert_caches_equal(cache_t, cache_j)

    serve_j = jsteps.make_serve_step(cfg_j)
    serve_t = tsteps.make_serve_step(cfg_t)
    for _ in range(2):
        pos = np.asarray(cache_j["lens"])
        tok_j, cache_j = serve_j(pj, cache_j, tok_j, jnp.asarray(pos), None)
        tok_t, cache_t = serve_t(pt, cache_t, tok_t,
                                 torch.from_numpy(pos.copy()), None)
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        _assert_caches_equal(cache_t, cache_j)


def test_temperature_sampling_gives_tokens_in_the_vocab():
    cfg = smoke_config("smollm-135m")
    params = treg.get_api(cfg).init(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 10), dtype=np.int32))
    gen = torch.Generator().manual_seed(1)
    tok, cache = tsteps.make_prefill_step(cfg, max_len=16, temperature=0.8)(
        params, {"tokens": tokens}, gen)
    assert tuple(tok.shape) == (3,)
    tok, _ = tsteps.make_serve_step(cfg, temperature=0.8)(
        params, cache, tok, cache["lens"], gen)
    assert tuple(tok.shape) == (3,)
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab


# ---------------------------------------------------------------------------
# roofline and the dry run
# ---------------------------------------------------------------------------

def test_roofline_formulas_equal_jax(monkeypatch):
    monkeypatch.setattr(tan, "HW", dict(jan.HW))
    args = (3.2e15, 7.5e14, 1.0e9, 2.0e10)
    assert tan.roofline_terms(*args) == jan.roofline_terms(*args)
    assert tan.roofline_terms(1e12, 0.0, 0.0) == \
        jan.roofline_terms(1e12, 0.0, 0.0)
    cost = {"flops": 4.0e15, "bytes accessed": 9.0e13}
    for arch in ("smollm-135m", "grok-1-314b", "mamba2-2.7b"):
        cfg, cfg_j = get_config(arch), jax_get_config(arch)
        for kind in ("train", "prefill", "decode"):
            assert tan.model_flops(cfg, kind, 4096) == \
                jan.model_flops(cfg_j, kind, 4096)
            assert tan.summarize_cell(cfg, kind, 4096, 1, cost, {"total": 0},
                                      io_bytes=3e9) == \
                jan.summarize_cell(cfg_j, kind, 4096, 1, cost, {"total": 0},
                                   io_bytes=3e9)


def test_h100_constants():
    assert mesh.HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                       "ici_bw": 450e9, "hbm_bytes": 80e9}
    assert tan.HW is mesh.HW


def test_cost_counter_counts_products_and_bytes():
    a, b = _meta(64, 32), _meta(32, 16, dtype=torch.float32)
    cost, out = tan.cost_analysis(lambda x, y: (x @ y).relu(), a, b)
    assert cost["flops"] == 2 * 64 * 32 * 16
    # mm: read a and b, write out; relu: read out, write out
    assert cost["bytes accessed"] == 4 * (64 * 32 + 32 * 16 + 3 * 64 * 16)
    assert out.device.type == "meta"


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "train_4k"), ("smollm-135m", "prefill_32k"),
    ("smollm-135m", "decode_32k"), ("mamba2-2.7b", "long_500k")])
def test_full_config_cells_count_ok(arch, shape):
    rec = dryrun.record_cell(get_config(arch), shape)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_chips"] == 1
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["cost_analysis"]["bytes accessed"] > 0
    mem = rec["memory_analysis"]
    io = mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
    assert rec["fits_one_card"] == (io <= mesh.HW["hbm_bytes"])
    r = rec["roofline"]
    assert r["step_time_lower_bound_s"] == max(r["compute_s"], r["memory_s"])
    kind = SHAPES[shape].kind
    n = SHAPES[shape].global_batch * (1 if kind == "decode"
                                     else SHAPES[shape].seq_len)
    assert r["model_flops_total"] == tan.model_flops(get_config(arch), kind, n)
    if shape == "decode_32k":
        # smollm's 30 layers of K and V for 128 x 32,768 positions
        assert mem["argument_size_in_bytes"] > 2 * 30 * 128 * 32768 * 3 * 64 * 2
        assert not rec["fits_one_card"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_family_counts_ok_at_smoke_size(family):
    cfg = smoke_config(FAMILIES[family])
    for shape in SHAPES:
        rec = dryrun.record_cell(cfg, shape)
        ok, reason = shape_applicable(cfg, SHAPES[shape])
        assert rec["status"] == ("ok" if ok else "skipped"), rec.get("error")
        assert rec.get("reason", "") == reason


def test_dryrun_cli_writes_records_and_skips(tmp_path, capsys):
    assert dryrun.main(["--arch", "smollm-135m", "--shape",
                        "decode_32k,long_500k", "--out", str(tmp_path)]) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["smollm-135m__decode_32k__1xH100.json",
                     "smollm-135m__long_500k__1xH100.json"]
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[ok     ] smollm-135m x decode_32k x 1xH100")
    assert out[1] == "[skipped] smollm-135m x long_500k x 1xH100"


def test_train_compile_only_runs_the_train_4k_cell(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    assert ttrain.main(["--arch", "smollm-135m", "--compile-only"]) == 0
    assert capsys.readouterr().out.startswith("ok {")
    assert (tmp_path / "results" / "dryrun" /
            "smollm-135m__train_4k__1xH100.json").exists()
