"""The port's vlm family (paligemma-3b) against JAX, on the CPU.

* The model paths: ``forward`` (logits over the patch prefix and the
  tokens), ``prefill`` (prefix-LM attention over random patches, as
  ``tests/test_decode_parity.py`` draws them), ``prefill_kv``,
  ``decode_step``, ``decode_step_paged`` and ``prefill_chunk_paged``.
* ``kv_cache.write_prefill_pages`` against JAX's.
* Both engine caches in lockstep with the JAX engine: the paged one
  prefills a vlm single-shot (``prefill_kv`` then the page writes), the
  slot-ring one keeps the prefix in its ring.
* ROADMAP.md C9, reproduced on purpose: the paged path keeps only the
  text tokens' K/V, at rope positions from ``prefix_len`` on, and its
  decode then runs at the bucket's positions without the prefix.
  :func:`c9_drift` measures how far that moves the greedy tokens from
  the slot-ring path's.
* One train step's loss and gradients with the launcher's stub patches.

Weights come from the JAX ``transformer.init(PRNGKey(0))`` and reach the
port through ``bridge.params_from_numpy``; other inputs are made with
numpy from a seed. Tolerances as ``test_torch_model.py``: float32
``atol=rtol=1e-4`` on logits and caches (two layers of the same math
summed in another order); bfloat16 ``atol=rtol=5e-2``; gradients
``atol=1e-6, rtol=1e-4`` as ``test_torch_train.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.scheduler import DriftScheduler as JaxScheduler
from repro.data import pipeline as jax_pipeline
from repro.models import steps as jsteps
from repro.models import transformer as jtr
from repro.serving import kv_cache as jkv
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxEngine
from repro.workload.generator import GeneratorConfig as JaxGeneratorConfig
from repro.workload.generator import WorkloadGenerator as JaxGenerator
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.core.scheduler import DriftScheduler
from repro_torch.data import pipeline
from repro_torch.models import steps
from repro_torch.models import transformer as ttr
from repro_torch.models.registry import get_api
from repro_torch.serving import kv_cache
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator

VLM = "paligemma-3b"
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _params(dtype="float32"):
    """(jax cfg, port cfg, jax params, port params); read-only."""
    cfg_j = jax_smoke_config(VLM).replace(dtype=dtype)
    cfg_t = smoke_config(VLM).replace(dtype=dtype)
    pj = jtr.init(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(cfg_t, jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfg_j, cfg_t, pj, pt


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.detach().float().numpy()


def _inputs(cfg, B, L, seed):
    """Tokens [B, L] and 0.02 N(0, 1) patches [B, prefix_len, d], bf16
    as ``tests/test_decode_parity.py`` makes them (float32 values)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, size=(B, L)).astype(np.int32)
    patches = (0.02 * rng.standard_normal((B, cfg.prefix_len, cfg.d_model))
               ).astype(np.float32)
    patches = np.asarray(jnp.asarray(patches, jnp.bfloat16), np.float32)
    return toks, patches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    cfg_j, cfg_t, pj, pt = _params(dtype)
    toks, patches = _inputs(cfg_t, 2, 12, 1)
    lj, aux_j = jtr.forward(cfg_j, pj, jnp.asarray(toks),
                            patches=jnp.asarray(patches))
    lt, aux_t = ttr.forward(cfg_t, pt, torch.from_numpy(toks),
                            patches=torch.from_numpy(patches))
    assert tuple(lt.shape) == (2, cfg_t.prefix_len + 12, cfg_t.vocab)
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL[dtype])
    assert aux_t.item() == float(aux_j) == 0.0
    with pytest.raises(ValueError, match="patch"):
        ttr.forward(cfg_t, pt, torch.from_numpy(toks))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_prefill_kv_and_decode_step_match_jax(dtype):
    """Slot-ring prefill of prefix + 16 positions into a 40-slot cache
    (logits and the whole cache), two decode steps, and ``prefill_kv``
    (S = the token count: the text tokens' K/V only)."""
    cfg_j, cfg_t, pj, pt = _params(dtype)
    toks, patches = _inputs(cfg_t, 2, 16, 2)
    lj, cj = jtr.prefill(cfg_j, pj, jnp.asarray(toks),
                         patches=jnp.asarray(patches), max_len=40)
    lt, ct = ttr.prefill(cfg_t, pt, torch.from_numpy(toks),
                         patches=torch.from_numpy(patches), max_len=40)
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL[dtype])
    assert ct["lens"].tolist() == [cfg_t.prefix_len + 16] * 2
    for name in ("k", "v"):
        np.testing.assert_allclose(_t(ct[name]), _np(cj[name]), **TOL[dtype])
    rng = np.random.default_rng(3)
    for step in range(2):
        tok = rng.integers(1, cfg_t.vocab, size=(2,)).astype(np.int32)
        pos = np.asarray(cj["lens"])
        lj, cj = jtr.decode_step(cfg_j, pj, cj, jnp.asarray(tok),
                                 jnp.asarray(pos))
        lt, ct = ttr.decode_step(cfg_t, pt, ct, torch.from_numpy(tok),
                                 ct["lens"])
        np.testing.assert_allclose(_t(lt), _np(lj), **TOL[dtype],
                                   err_msg=f"step {step}")
    lkj, kj, vj = jtr.prefill_kv(cfg_j, pj, jnp.asarray(toks),
                                 patches=jnp.asarray(patches))
    lkt, kt, vt = ttr.prefill_kv(cfg_t, pt, torch.from_numpy(toks),
                                 patches=torch.from_numpy(patches))
    assert tuple(kt.shape) == kj.shape == (cfg_t.n_layers, 2, 16,
                                           cfg_t.n_kv_heads, cfg_t.d_head)
    np.testing.assert_allclose(_t(lkt), _np(lkj), **TOL[dtype])
    np.testing.assert_allclose(_t(kt), _np(kj), **TOL[dtype])
    np.testing.assert_allclose(_t(vt), _np(vj), **TOL[dtype])


def _scene(cfg, rng, B, pps, n_pages, page):
    shape = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.d_head)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    table = rng.permutation(n_pages - 1)[:B * pps].reshape(B, pps)
    return k, v, table.astype(np.int32)


def test_paged_paths_match_jax():
    """One prefill chunk at ``q_offset`` 13 and 8 and one decode step of
    three slots (mid-page, on a boundary, idle on the scratch page),
    pools included (float32)."""
    cfg_j, cfg_t, pj, pt = _params()
    rng = np.random.default_rng(4)
    B, page, pps, n_pages = 2, 8, 6, 16
    k, v, table = _scene(cfg_t, rng, B, pps, n_pages, page)
    pool_j = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    pool_t = {"k": torch.tensor(k), "v": torch.tensor(v)}
    toks = rng.integers(0, cfg_t.vocab, size=(B, 8)).astype(np.int32)
    q_off = np.array([13, 8], np.int32)
    lj, pool_j = jtr.prefill_chunk_paged(
        cfg_j, pj, pool_j, jnp.asarray(toks), jnp.asarray(table),
        jnp.asarray(q_off))
    lt = ttr.prefill_chunk_paged(
        cfg_t, pt, pool_t, torch.from_numpy(toks), torch.from_numpy(table),
        torch.from_numpy(q_off))
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL["float32"])
    table = np.concatenate([table, np.full((1, pps), n_pages - 1, np.int32)])
    lens = np.array([21, 16, 0], np.int32)
    tok = rng.integers(0, cfg_t.vocab, size=(3,)).astype(np.int32)
    lj, pool_j = jtr.decode_step_paged(
        cfg_j, pj, pool_j, jnp.asarray(tok), jnp.asarray(table),
        jnp.asarray(lens), max_pages=4)
    lt = ttr.decode_step_paged(
        cfg_t, pt, pool_t, torch.from_numpy(tok), torch.from_numpy(table),
        torch.from_numpy(lens), max_pages=4)
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL["float32"])
    for name in ("k", "v"):
        np.testing.assert_allclose(_t(pool_t[name][:, :-1]),
                                   _np(pool_j[name][:, :-1]), **TOL["float32"])


@pytest.mark.parametrize("start,n_tokens", [(0, 20), (8, 20), (16, 32)])
def test_write_prefill_pages_matches_jax(start, n_tokens):
    """Pages from ``start`` on, a last partial page zero-padded, the
    other pages untouched; a start off the page grid raises."""
    cfg = smoke_config(VLM).replace(dtype="float32")
    rng = np.random.default_rng(5)
    L, P, n_pages = cfg.n_layers, 8, 10
    shape = (L, n_pages, P, cfg.n_kv_heads, cfg.d_head)
    k0 = rng.standard_normal(shape, dtype=np.float32)
    v0 = rng.standard_normal(shape, dtype=np.float32)
    kv = rng.standard_normal((2, L, n_tokens, cfg.n_kv_heads, cfg.d_head),
                             dtype=np.float32)
    pages = [7, 2, 5, 0][:-(-(n_tokens - start) // P)]
    pj = jkv.write_prefill_pages(
        jkv.PagedPool(k=jnp.asarray(k0), v=jnp.asarray(v0), page_size=P),
        (jnp.asarray(kv[0]), jnp.asarray(kv[1])), pages, n_tokens,
        start_token=start)
    pool = kv_cache.PagedPool(k=torch.tensor(k0), v=torch.tensor(v0),
                              page_size=P)
    out = kv_cache.write_prefill_pages(
        pool, (torch.from_numpy(kv[0]), torch.from_numpy(kv[1])), pages,
        n_tokens, start_token=start)
    assert out is pool
    np.testing.assert_array_equal(pool.k.numpy(), np.asarray(pj.k))
    np.testing.assert_array_equal(pool.v.numpy(), np.asarray(pj.v))
    with pytest.raises(ValueError, match="page-aligned"):
        kv_cache.write_prefill_pages(pool, (torch.from_numpy(kv[0]),
                                            torch.from_numpy(kv[1])),
                                     pages, n_tokens, start_token=3)


# ---------------------------------------------------------------------------
# the engines in lockstep
# ---------------------------------------------------------------------------

def _plans(n, seed, **kw):
    gk = dict(total_requests=n, calibration_requests=n, seed=seed, **kw)
    jr = [r for _, r in JaxGenerator(JaxGeneratorConfig(**gk))
          .plan(seed=seed).calibration]
    tr = [r for _, r in WorkloadGenerator(GeneratorConfig(**gk))
          .plan(seed=seed).calibration]
    return jr, tr


def _record(reqs, sched):
    idx = {r.req_id: i for i, r in enumerate(reqs)}
    return [(idx[r.req_id], r.observed_output_tokens, r.cached_prompt_tokens,
             r.prefill_end, r.exec_end) for r in sched.completed]


ENGINE = dict(n_slots=3, max_len=96, prompt_buckets=(32, 64), page_size=8,
              prefix_cache_pages=16)


@pytest.mark.parametrize("paged,chunk,prefix", [(True, None, False),
                                                (True, 8, True),
                                                (False, 8, False)])
def test_engines_emit_the_same_tokens_in_lockstep(paged, chunk, prefix):
    """The port's and JAX's engine on the same weights and requests,
    stepped together (float32): the same last token in every slot after
    every step, the same completions, stamps and page accounting; a
    paged vlm prefills single-shot (no chunked-prefill launch), with
    prefix-cache hits read from pages donated by single-shot prefills."""
    cfg_j, cfg_t, pj, pt = _params()
    kw = dict(ENGINE, paged=paged, chunk_prefill_tokens=chunk,
              prefix_cache=prefix)
    js, ts = JaxScheduler("fifo"), DriftScheduler("fifo")
    je = JaxEngine(cfg_j, pj, js, JaxEngineConfig(**kw))
    te = ServingEngine(cfg_t, pt, ts, EngineConfig(**kw), device="cpu")
    assert not te._chunked_device_prefill
    jr, tr = _plans(7, seed=3, max_tokens=10,
                    shared_prefix_tokens=16 if prefix else 0,
                    prefix_groups_per_tenant=1)
    for i, (a, b) in enumerate(zip(jr, tr)):
        js.submit(a, 1e-6 * i)
        ts.submit(b, 1e-6 * i)
    now = 0.0
    while js.queue_depth() or je.active_slots():
        assert now < 500, "engines failed to drain"
        je.step(now)
        te.step(now)
        assert [s.last_token for s in te.slots] == \
            [s.last_token for s in je.slots], f"step {now}"
        now += 1.0
    assert len(ts.completed) == len(tr)
    assert _record(tr, ts) == _record(jr, js)
    assert te.step_count == je.step_count
    assert te.n_prefill_launches == je.n_prefill_launches == 0
    if paged:
        np.testing.assert_allclose(te.pool.k.numpy(), _np(je.pool.k),
                                   **TOL["float32"])
        assert te.prefix_cache_stats() == je.prefix_cache_stats()
        if prefix:
            assert te.prefix_cache_stats()["hits"] > 0
        held = te.alloc.free_pages + te.ledger.owned_pages() + (
            te.prefix_tree.total_pages() if prefix else 0)
        assert held == te.alloc.n_pages


# ---------------------------------------------------------------------------
# ROADMAP.md C9: the paged vlm path drops the image prefix
# ---------------------------------------------------------------------------

def test_paged_vlm_pool_holds_only_the_text_kv():
    """After a paged vlm prefill the slot's ledger holds ``bucket``
    tokens, not ``prefix_len + bucket``, and its pages hold exactly the
    K/V of the text tokens (rope positions prefix_len ..), bit-equal to
    positions ``[prefix_len, prefix_len + bucket)`` of the slot-ring
    prefill's cache: the prefix's K/V are nowhere in the pool."""
    _, cfg, _, params = _params()
    sched = DriftScheduler("fifo")
    eng = ServingEngine(cfg, params, sched, EngineConfig(
        **dict(ENGINE, paged=True)), device="cpu")
    req = [r for _, r in WorkloadGenerator(GeneratorConfig(
        total_requests=1, calibration_requests=1, max_tokens=10, seed=3))
        .plan(seed=3).calibration][0]
    sched.submit(req, 0.0)
    seen = {}

    def at_first_token(slot, r, now):         # before the step's decode
        seen.update(lens=eng.ledger.lens_array([slot]).tolist(),
                    pages=eng.ledger.table(slot),
                    k=eng.pool.k.clone(), v=eng.pool.v.clone())
        return False

    eng.handoff_hook = at_first_token
    eng.step(0.0)
    bucket = eng.slots[0].bucket
    assert seen["lens"] == [bucket]
    tokens = torch.from_numpy(eng._tokenize(req, bucket, min(
        req.prompt_tokens, bucket), 0))
    patches = torch.zeros(1, cfg.prefix_len, cfg.d_model)
    _, cache = ttr.prefill(cfg, params, tokens, patches=patches,
                           max_len=cfg.prefix_len + bucket)
    pages = seen["pages"][:bucket // ENGINE["page_size"]]
    for name in ("k", "v"):
        got = seen[name][:, pages].flatten(1, 2)
        want = cache[name][:, 0, cfg.prefix_len:]
        assert torch.equal(got, want), name


def c9_drift(n_steps=12, seed=3, bucket=32):
    """The paged vlm path against the slot-ring one on one prompt, at
    the function level (so that C1's page-0 write does not enter):
    prefill through ``prefill_kv`` into pages, then ``n_steps`` greedy
    ``decode_step_paged`` steps with every page allocated up front,
    against ``prefill`` into a ring that holds the prefix and greedy
    ``decode_step``; zero patches, as the engines feed. Returns (the
    largest |logit difference| of the first decode step, the number of
    greedy tokens that differ, n_steps + 1), float32 smoke config."""
    _, cfg, _, params = _params()
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(1, cfg.vocab, size=(1, bucket)).astype(np.int64))
    patches = torch.zeros(1, cfg.prefix_len, cfg.d_model)
    lr, cache = ttr.prefill(cfg, params, tokens, patches=patches,
                            max_len=cfg.prefix_len + bucket + n_steps)
    lp, k, v = ttr.prefill_kv(cfg, params, tokens, patches=patches)
    P = 8
    n_pages = -(-(bucket + n_steps) // P)
    pool = kv_cache.PagedPool.create(cfg, n_pages + 1, P, device="cpu")
    table = torch.arange(n_pages, dtype=torch.int32)[None]
    kv_cache.write_prefill_pages(pool, (k[:, 0], v[:, 0]),
                                 list(range(n_pages)), bucket)
    toks_r, toks_p = [int(lr.argmax())], [int(lp.argmax())]
    first = None
    for i in range(n_steps):
        lr, cache = ttr.decode_step(cfg, params, cache,
                                    torch.tensor([toks_r[-1]]), cache["lens"])
        lp = ttr.decode_step_paged(
            cfg, params, {"k": pool.k, "v": pool.v},
            torch.tensor([toks_p[-1]]), table,
            torch.tensor([bucket + i], dtype=torch.int32))
        if first is None:
            first = (lr - lp).abs().max().item()
        toks_r.append(int(lr.argmax()))
        toks_p.append(int(lp.argmax()))
    return first, sum(a != b for a, b in zip(toks_r, toks_p)), n_steps + 1


def test_paged_vlm_decode_drifts_from_the_slot_ring():
    """C9 pinned: the prefill's logits agree (both see the prefix), the
    paged path's first decode logits do not (no prefix keys, rope at the
    bucket's position), far beyond the float32 tolerance."""
    first, flips, n = c9_drift()
    assert first > 100 * TOL["float32"]["atol"]
    assert 0 < flips <= n


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + ".") if isinstance(v, dict) else {name: v})
    return out


def test_loss_and_grads_with_stub_patches_match_jax():
    """One batch of the synthetic pipeline with the launcher's stub
    patches (``attach_modality_stubs``, ``default_rng(0)`` on both
    sides): the logits cover prefix + tokens and the loss scores the
    tail; the loss and every gradient against JAX's (float32)."""
    cfg_j, cfg_t, pj, pt = _params()
    raw = jax_pipeline.make_dataset("synthetic", cfg_j, 32, 2).batch(0)
    raw_j = jax_pipeline.attach_modality_stubs(cfg_j, dict(raw),
                                               np.random.default_rng(0))
    raw_t = pipeline.attach_modality_stubs(cfg_t, dict(raw),
                                           np.random.default_rng(0))
    np.testing.assert_array_equal(raw_t["patches"], raw_j["patches"])
    bj = {k: jnp.asarray(v) for k, v in raw_j.items()}
    bt = {k: torch.from_numpy(v) for k, v in raw_t.items()}
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jsteps.loss_fn(cfg_j, p, bj), has_aux=True)(pj)
    params = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True),
                                    pt)
    logits, _ = get_api(cfg_t).forward(cfg_t, params, bt)
    assert logits.shape[1] == cfg_t.prefix_len + 32
    loss_t, _ = steps.loss_fn(cfg_t, params, bt)
    grads_t = steps.grads_of(loss_t, params)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    gj, gt = _flat(grads_j), _flat(grads_t)
    assert sorted(gj) == sorted(gt)
    for name in gj:
        np.testing.assert_allclose(_t(gt[name]), _np(gj[name]),
                                   err_msg=name, **GRAD_TOL)
