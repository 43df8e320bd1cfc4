"""The port's MoE family (grok-1-314b and llama4-scout-17b-a16e) against
JAX, on the CPU.

* ``moe_block`` and ``moe_block_decode``: the output, the aux loss and
  the routing (each (token, k)'s expert one-hot and kept-entry mask,
  read off JAX's dispatch ``einsum`` by a spy on the module's ``jnp``)
  on both smoke configs; a variant at capacity factor 1.25 with groups
  of 16 over 26 tokens, so that entries are dropped and a group is
  padded with zero rows; and inputs with zero rows, whose router logits
  tie exactly (the port's stable descending sort must pick the lower
  expert first, as ``jax.lax.top_k`` does).
* The model paths of both archs: ``forward`` (logits and aux),
  ``prefill``, ``prefill_kv``, ``decode_step``, ``decode_step_paged``
  and ``prefill_chunk_paged``.
* Both engine caches in lockstep with the JAX engine.
* One train step's loss, aux and gradients (grok smoke).

Weights come from the JAX ``transformer.init(PRNGKey(0))`` and reach the
port through ``bridge.params_from_numpy``; other inputs are made with
numpy from a seed. Tolerances: float32 ``atol=rtol=1e-5`` on a layer
(``LAYER_TOL`` of ``test_torch_model.py``) and 1e-4 on logits through
two layers; bfloat16 ``atol=rtol=5e-2`` (activations round to bf16 at
different points in the two frameworks); gradients ``atol=1e-6,
rtol=1e-4`` as ``test_torch_train.py``. The routing (one-hots and kept
mask) must be equal.
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
from repro.models import layers as jl
from repro.models import steps as jsteps
from repro.models import transformer as jtr
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxEngine
from repro.workload.generator import GeneratorConfig as JaxGeneratorConfig
from repro.workload.generator import WorkloadGenerator as JaxGenerator
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.core.scheduler import DriftScheduler
from repro_torch.models import layers as tl
from repro_torch.models import steps
from repro_torch.models import transformer as ttr
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator

MOE = ("grok-1-314b", "llama4-scout-17b-a16e")
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
# capacity factor 1.25 and groups of 16: entries dropped, a padded group
DROPS = dict(moe_capacity_factor=1.25, moe_group_size=16)


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32", **over):
    """(jax cfg, port cfg, jax params, port params); read-only."""
    cfg_j = jax_smoke_config(arch).replace(dtype=dtype, **over)
    cfg_t = smoke_config(arch).replace(dtype=dtype, **over)
    pj = jtr.init(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(cfg_t, jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfg_j, cfg_t, pj, pt


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.detach().float().numpy()


class _RouteSpy:
    """``jnp`` for JAX's ``layers`` module with ``einsum`` recording the
    operands of the dispatch einsum (``onehot``, ``cap_oh``, ``keep``):
    JAX's routing as it computed it."""

    def __init__(self):
        self.dispatch = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec == "gtke,gtkc,gtk->gtec" and len(ops) == 3:
            self.dispatch.append(ops)
        return jnp.einsum(spec, *ops, **kw)


def _jax_moe(monkeypatch, cfg_j, p, x):
    """JAX's ``moe_block`` on x: (out, aux, onehot, keep)."""
    spy = _RouteSpy()
    monkeypatch.setattr(jl, "jnp", spy)
    out, aux = jl.moe_block(cfg_j, p, jnp.asarray(x))
    monkeypatch.undo()
    onehot, _, keep = spy.dispatch[0]        # the disp einsum (comb is 2nd)
    return out, aux, np.asarray(onehot), np.asarray(keep)


def _port_moe(cfg_t, p, x):
    """The port's ``moe_block`` on the tensor x and its routing, read
    off ``layers.moe_route``: (out, aux, onehot, keep)."""
    routes = []
    route = tl.moe_route

    def spy(cfg, lp, xg):
        routes.append(route(cfg, lp, xg))
        return routes[-1]

    tl.moe_route = spy
    try:
        out, aux = tl.moe_block(cfg_t, p, x)
    finally:
        tl.moe_route = route
    return out, aux, routes[0]["onehot"].numpy(), routes[0]["keep"].numpy()


def _layer0(pj, pt):
    return (jax.tree_util.tree_map(lambda a: a[0], pj["layers"]["moe"]),
            ttr.layer_params(pt, 0)["moe"])


def _moe_inputs(cfg, shape, seed, zero_rows=()):
    x = np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model), dtype=np.float32)
    x = x.reshape(-1, cfg.d_model)
    x[list(zero_rows)] = 0.0
    return x.reshape(*shape, cfg.d_model)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("variant,shape,zero_rows", [
    ("smoke", (2, 12), ()),
    ("drops", (2, 13), ()),                  # 26 tokens: groups 16 + 10 pad
    ("drops", (2, 13), (1, 4, 5, 20)),       # tied logits compete too
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_jax(monkeypatch, arch, variant, shape, zero_rows,
                               dtype):
    over = DROPS if variant == "drops" else {}
    cfg_j, cfg_t, pj, pt = _params(arch, dtype, **over)
    x = _moe_inputs(cfg_t, shape, 11, zero_rows)
    lj, lt = _layer0(pj, pt)
    xj = jnp.asarray(x).astype(cfg_j.dtype)              # the same inputs
    out_j, aux_j, oh_j, keep_j = _jax_moe(monkeypatch, cfg_j, lj, xj)
    out_t, aux_t, oh_t, keep_t = _port_moe(
        cfg_t, lt, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out_t.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(oh_t, oh_j)
    np.testing.assert_array_equal(keep_t, keep_j)
    tol = LAYER_TOL if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(_t(out_t), _np(out_j), **tol)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-6)
    assert aux_t.dtype == torch.float32
    if variant == "drops":
        assert (keep_t == 0).any(), "no entry dropped"


def test_tied_router_logits_pick_the_lower_experts():
    """A zero row's router logits are all equal: its top-k is experts
    0 .. K-1 in order, as ``jax.lax.top_k`` gives, with probabilities
    1/K after renormalisation."""
    for arch in MOE:
        _, cfg_t, _, pt = _params(arch)
        lt = ttr.layer_params(pt, 0)["moe"]
        r = tl.moe_route(cfg_t, lt, torch.zeros(1, 5, cfg_t.d_model))
        K = cfg_t.experts_per_token
        assert r["top_e"].tolist() == [[list(range(K))] * 5]
        np.testing.assert_allclose(r["top_p"].numpy(), 1.0 / K, rtol=1e-6)
        # five zero rows on experts 0..K-1: each expert's places 0..4
        assert r["pos_sel"][0, :, 0].tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("B,zero_rows,experts", [(3, (), None),
                                                  (8, (2, 4, 5, 6, 7), 8)])
def test_moe_block_decode_matches_jax(arch, B, zero_rows, experts):
    """One group of all B rows at capacity factor 2.0. The idle slots'
    rows (here zeros, tied on experts 0 .. K-1) take their share of the
    capacity: with 8 experts it is 4 a group of 8 rows, so the fifth
    zero row is dropped."""
    over = {} if experts is None else dict(n_experts=experts)
    cfg_j, cfg_t, pj, pt = _params(arch, **over)
    lj, lt = _layer0(pj, pt)
    x = _moe_inputs(cfg_t, (B,), 12, zero_rows)
    got = tl.moe_block_decode(cfg_t, lt, torch.from_numpy(x))
    want = jl.moe_block_decode(cfg_j, lj, jnp.asarray(x))
    np.testing.assert_allclose(_t(got), _np(want), **LAYER_TOL)
    r = tl.moe_route(cfg_t.replace(moe_group_size=B, moe_capacity_factor=2.0),
                     lt, torch.from_numpy(x)[None])
    assert bool((r["keep"] == 0).any()) == bool(zero_rows)


# ---------------------------------------------------------------------------
# the model paths
# ---------------------------------------------------------------------------

def _scene(cfg, rng, B, pps, n_pages, page):
    """A pool with random resident K/V and non-overlapping page tables
    (page n_pages - 1 is the scratch page, never in a table)."""
    shape = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.d_head)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    table = rng.permutation(n_pages - 1)[:B * pps].reshape(B, pps)
    return k, v, table.astype(np.int32)


def _pools(k, v, dtype):
    return ({"k": jnp.asarray(k).astype(dtype), "v": jnp.asarray(v).astype(dtype)},
            {"k": torch.tensor(k, dtype=getattr(torch, dtype)),
             "v": torch.tensor(v, dtype=getattr(torch, dtype))})


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_and_aux_match_jax(arch):
    """float32 only: through two bf16 layers the two frameworks' roundings
    flip some tokens' routing (grok smoke: 19 of 10,240 logits off by up
    to 0.085, the aux by 7e-4), a discrete change no tolerance bounds.
    bf16 is compared at the layer, on the same inputs, routing and all
    (``test_moe_block_matches_jax``)."""
    dtype = "float32"
    cfg_j, cfg_t, pj, pt = _params(arch, dtype)
    toks = np.random.default_rng(1).integers(
        0, cfg_t.vocab, size=(2, 20)).astype(np.int32)
    lj, aux_j = jtr.forward(cfg_j, pj, jnp.asarray(toks))
    lt, aux_t = ttr.forward(cfg_t, pt, torch.from_numpy(toks))
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL[dtype])
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-5)
    assert aux_t.item() > 0


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_step_match_jax(arch):
    """Slot-ring prefill (logits and the whole cache) and two decode
    steps at per-slot positions; ``prefill_kv``'s K/V and logits."""
    cfg_j, cfg_t, pj, pt = _params(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg_t.vocab, size=(3, 16)).astype(np.int32)
    lj, cj = jtr.prefill(cfg_j, pj, jnp.asarray(toks), max_len=40)
    lt, ct = ttr.prefill(cfg_t, pt, torch.from_numpy(toks), max_len=40)
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL["float32"])
    for name in ("k", "v"):
        np.testing.assert_allclose(_t(ct[name]), _np(cj[name]),
                                   **TOL["float32"])
    lkj, kj, vj = jtr.prefill_kv(cfg_j, pj, jnp.asarray(toks))
    lkt, kt, vt = ttr.prefill_kv(cfg_t, pt, torch.from_numpy(toks))
    np.testing.assert_allclose(_t(lkt), _np(lkj), **TOL["float32"])
    assert tuple(kt.shape) == kj.shape == (cfg_t.n_layers, 3, 16,
                                           cfg_t.n_kv_heads, cfg_t.d_head)
    np.testing.assert_allclose(_t(kt), _np(kj), **TOL["float32"])
    np.testing.assert_allclose(_t(vt), _np(vj), **TOL["float32"])
    for step in range(2):
        tok = rng.integers(1, cfg_t.vocab, size=(3,)).astype(np.int32)
        pos = np.asarray(cj["lens"])
        lj, cj = jtr.decode_step(cfg_j, pj, cj, jnp.asarray(tok),
                                 jnp.asarray(pos))
        lt, ct = ttr.decode_step(cfg_t, pt, ct, torch.from_numpy(tok),
                                 ct["lens"])
        np.testing.assert_allclose(_t(lt), _np(lj), **TOL["float32"],
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("arch", MOE)
def test_paged_paths_match_jax(arch):
    """One prefill chunk at ``q_offset`` 13 and 8, then one decode step
    of three slots (mid-page, on a boundary, idle on the scratch page),
    each against JAX's, pools included."""
    cfg_j, cfg_t, pj, pt = _params(arch)
    rng = np.random.default_rng(3)
    B, page, pps, n_pages = 2, 8, 6, 16
    k, v, table = _scene(cfg_t, rng, B, pps, n_pages, page)
    toks = rng.integers(0, cfg_t.vocab, size=(B, 8)).astype(np.int32)
    q_off = np.array([13, 8], np.int32)
    pool_j, pool_t = _pools(k, v, "float32")
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


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("paged,chunk,prefix", [(True, 8, True),
                                                (False, None, False)])
def test_engines_emit_the_same_tokens_in_lockstep(arch, paged, chunk, prefix):
    """The port's and JAX's engine on the same weights and requests,
    stepped together (float32): the same last token in every slot after
    every step (idle slots' rows share each decode group's capacity on
    both), the same completions, stamps and page accounting."""
    cfg_j, cfg_t, pj, pt = _params(arch)
    kw = dict(n_slots=3, max_len=96, prompt_buckets=(32, 64), paged=paged,
              page_size=8, chunk_prefill_tokens=chunk, prefix_cache=prefix,
              prefix_cache_pages=16)
    js, ts = JaxScheduler("fifo"), DriftScheduler("fifo")
    je = JaxEngine(cfg_j, pj, js, JaxEngineConfig(**kw))
    te = ServingEngine(cfg_t, pt, ts, EngineConfig(**kw), device="cpu")
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
        if not paged:
            np.testing.assert_array_equal(te.cache["lens"].numpy(),
                                          np.asarray(je.cache["lens"]))
        now += 1.0
    assert len(ts.completed) == len(tr)
    assert _record(tr, ts) == _record(jr, js)
    assert te.step_count == je.step_count
    if paged:
        assert te.prefill_chunk_log == je.prefill_chunk_log
        assert te.prefix_cache_stats() == je.prefix_cache_stats()
        assert te.prefix_cache_stats()["hits"] > 0
        assert te.alloc.free_pages + te.ledger.owned_pages() + \
            te.prefix_tree.total_pages() == te.alloc.n_pages


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + ".") if isinstance(v, dict) else {name: v})
    return out


def test_loss_aux_and_grads_match_jax():
    """grok smoke, float32, at capacity factor 1.25 and groups of 16
    (entries dropped): the total loss (cross-entropy plus
    ``router_aux_coef`` x aux), the aux, and every gradient, the
    router's included."""
    cfg_j, cfg_t, pj, pt = _params("grok-1-314b", **DROPS)
    raw = jax_pipeline.make_dataset("synthetic", cfg_j, 32, 2).batch(0)
    bj = {k: jnp.asarray(v) for k, v in raw.items()}
    bt = {k: torch.from_numpy(v) for k, v in raw.items()}
    (loss_j, mj), grads_j = jax.value_and_grad(
        lambda p: jsteps.loss_fn(cfg_j, p, bj), has_aux=True)(pj)
    params = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True),
                                    pt)
    loss_t, mt = steps.loss_fn(cfg_t, params, bt)
    grads_t = steps.grads_of(loss_t, params)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    np.testing.assert_allclose(mt["aux"].item(), float(mj["aux"]), rtol=1e-5)
    assert mt["aux"].item() > 0
    gj, gt = _flat(grads_j), _flat(grads_t)
    assert sorted(gj) == sorted(gt) and "layers.moe.router" in gt
    for name in gj:
        np.testing.assert_allclose(_t(gt[name]), _np(gj[name]),
                                   err_msg=name, **GRAD_TOL)
