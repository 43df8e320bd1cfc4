"""The port's training path against JAX, on the CPU: the Mamba-2 and
dense forwards, the loss and its gradients, AdamW, whole train steps in
lockstep, the data pipeline, checkpoints and the launcher.

Weights come from the JAX ``init`` (``PRNGKey(0)``) of
``smoke_config("mamba2-2.7b")`` (2 layers, d_model 64, 8 SSM heads of
16, state 16, chunk 32) and ``smoke_config("smollm-135m")`` and reach
the port through ``bridge.params_from_numpy``; tokens come from numpy
with a seed or from the JAX data pipeline. The Mamba-2 sequences span
at least three chunks, and one is ragged. JAX runs on the CPU (its SSD
through the Pallas body in interpret mode, or through ``ref.ssd_chunked``
as ``impl='auto'`` does off the TPU); the port runs its plain kernel
versions.

Tolerances: float32 forwards ``atol=rtol=1e-5`` on the Mamba-2 logits
and the conv (the same float32 math in another summation order, two
layers deep) and 1e-4 on the dense logits, as ``test_torch_model.py``;
bfloat16 ``atol=rtol=5e-2`` (activations round to bf16 after every op,
at different points in the two frameworks). Gradients ``atol=1e-6,
rtol=1e-4`` (float32 backward of the same graph; the smallest entries
differ in the last bits). Train steps: loss, grad norm and lr to
``rtol=1e-5``; params after three AdamW steps (lr 1e-3) within
``atol=2e-6, rtol=1e-5`` in at least 99.9% of the entries of each leaf
and within ``5e-5`` (5% of lr) everywhere: the Adam direction
``m / (sqrt(v) + eps)`` of an entry whose gradient is as small as
``eps`` (1e-8) moves by several percent when the two gradients differ
in their last bits, which a few entries of a leaf do.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.distributed import optimizer as jopt
from repro.distributed.checkpoint import CheckpointManager as JaxCheckpoints
from repro.models import mamba2 as jm
from repro.models import steps as jsteps
from repro.models import transformer as jtr
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.data import pipeline
from repro_torch.distributed import optimizer as topt
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.launch import train as launch_train
from repro_torch.models import mamba2 as tm
from repro_torch.models import encdec, hybrid, registry, steps
from repro_torch.models import transformer as ttr

SSM, DENSE = "mamba2-2.7b", "smollm-135m"
FWD_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
           "bfloat16": dict(atol=5e-2, rtol=5e-2)}
DENSE_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
             "bfloat16": dict(atol=5e-2, rtol=5e-2)}
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
JAX_INIT = {SSM: jm.init, DENSE: jtr.init, "h2o-danube-1.8b": jtr.init}


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    """(jax cfg, port cfg, jax params, port params); read-only."""
    cfg_j = jax_smoke_config(arch).replace(dtype=dtype)
    cfg_t = smoke_config(arch).replace(dtype=dtype)
    pj = JAX_INIT[arch](cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(cfg_t, jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfg_j, cfg_t, pj, pt


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.detach().float().numpy()


def _tokens(cfg, B, L, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, L)).astype(np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# init, bridge, layers
# ---------------------------------------------------------------------------

def test_mamba2_init_layouts_and_dtypes():
    cfg = smoke_config(SSM)
    params = tm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, _, pj, _ = _params(SSM, "bfloat16")
    shapes_t = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in _flat(params).items()}
    shapes_j = {k: (tuple(v.shape), str(v.dtype))
                for k, v in _flat(pj).items()}
    assert shapes_t == shapes_j
    sp = params["layers"]["ssm"]
    for name in ("A_log", "D", "dt_bias"):
        assert sp[name].dtype == torch.float32
    H = cfg.ssm_heads
    torch.testing.assert_close(sp["A_log"][1],
                               torch.log(torch.arange(1, H + 1).float()))
    dt = torch.nn.functional.softplus(sp["dt_bias"])
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001
    std = sp["w_x"].float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_bridge_keeps_float32_leaves_of_a_bf16_mamba2_tree():
    _, _, pj, pt = _params(SSM, "bfloat16")
    sp = pt["layers"]["ssm"]
    for name in ("A_log", "D", "dt_bias"):
        assert sp[name].dtype == torch.float32
        np.testing.assert_array_equal(sp[name].numpy(),
                                      np.asarray(pj["layers"]["ssm"][name]))
    assert sp["w_x"].dtype == torch.bfloat16
    assert pt["embed"]["table"].dtype == torch.bfloat16


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32)
    b = rng.standard_normal((24,), dtype=np.float32)
    got = tm._causal_conv(*(torch.from_numpy(t) for t in (x, w, b)))
    want = jm._causal_conv(*(jnp.asarray(t) for t in (x, w, b)))
    np.testing.assert_allclose(_t(got), _np(want), **FWD_TOL["float32"])


def test_layer_norm_and_norm_dispatch():
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 16), dtype=np.float32)
    s, b = (rng.standard_normal((16,), dtype=np.float32) for _ in range(2))
    np.testing.assert_allclose(
        _t(tl.layer_norm(*(torch.from_numpy(t) for t in (x, s, b)))),
        _np(jl.layer_norm(*(jnp.asarray(t) for t in (x, s, b)))), atol=1e-5,
        rtol=1e-5)
    for norm in ("layernorm", "rmsnorm"):
        cfg_j = jax_smoke_config(DENSE).replace(norm=norm, dtype="float32")
        cfg_t = smoke_config(DENSE).replace(norm=norm, dtype="float32")
        pt = tl.init_norm(cfg_t, "cpu")
        pj = jl.init_norm(jax.random.PRNGKey(0), cfg_j)
        assert sorted(pt) == sorted(pj)
        xs = rng.standard_normal((2, cfg_t.d_model), dtype=np.float32)
        np.testing.assert_allclose(
            _t(tl.apply_norm(cfg_t, pt, torch.from_numpy(xs))),
            _np(jl.apply_norm(cfg_j, pj, jnp.asarray(xs))), atol=1e-5,
            rtol=1e-5)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,jax_impl,L", [
    ("float32", "pallas_interpret", 96),   # the Pallas body, 3 chunks
    ("float32", "auto", 96),
    ("float32", "auto", 80),               # ragged: 2 chunks + 16 tokens
    ("bfloat16", "auto", 96),
])
def test_mamba2_forward_matches_jax(dtype, jax_impl, L):
    cfg_j, cfg_t, pj, pt = _params(SSM, dtype)
    tj, tt = _tokens(cfg_t, 2, L, seed=3)
    want, aux_j = jm.forward(cfg_j, pj, tj, attn_impl=jax_impl)
    got, aux_t = tm.forward(cfg_t, pt, tt)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, L, cfg_t.vocab) and float(aux_t) == float(aux_j)
    np.testing.assert_allclose(_t(got), _np(want), **FWD_TOL[dtype])
    remat, _ = tm.forward(cfg_t, pt, tt, remat=True)
    torch.testing.assert_close(remat, got, atol=0, rtol=0)


@pytest.mark.parametrize("arch", [DENSE, "h2o-danube-1.8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_forward_matches_jax(arch, dtype):
    cfg_j, cfg_t, pj, pt = _params(arch, dtype)
    tj, tt = _tokens(cfg_t, 2, 40, seed=4)          # > h2o-danube's window 16
    want, _ = jtr.forward(cfg_j, pj, tj)
    got, aux = ttr.forward(cfg_t, pt, tt)
    assert float(aux) == 0.0 and got.shape == (2, 40, cfg_t.vocab)
    np.testing.assert_allclose(_t(got), _np(want), **DENSE_TOL[dtype])


@pytest.mark.parametrize("path", ["forward", "slot_ring", "paged"])
def test_dense_layernorm_matches_jax(path):
    """A layernorm dense config (scale and bias drawn away from their
    init) takes ``cfg.norm`` on the training and both serving paths."""
    cfg_j = jax_smoke_config(DENSE).replace(dtype="float32", norm="layernorm")
    cfg_t = smoke_config(DENSE).replace(dtype="float32", norm="layernorm")
    rng = np.random.default_rng(11)
    npj = jax.tree_util.tree_map(np.asarray, jtr.init(cfg_j,
                                                      jax.random.PRNGKey(0)))
    for group in (npj["layers"]["ln1"], npj["layers"]["ln2"],
                  npj["final_norm"]):
        for name in ("scale", "bias"):
            group[name] = group[name] + rng.normal(
                0, 0.5, group[name].shape).astype(np.float32)
    pj = jax.tree_util.tree_map(jnp.asarray, npj)
    pt = params_from_numpy(cfg_t, npj, device="cpu")
    toks = rng.integers(0, cfg_t.vocab, size=(2, 12)).astype(np.int32)
    tol = DENSE_TOL["float32"]
    if path == "forward":
        want, _ = jtr.forward(cfg_j, pj, jnp.asarray(toks))
        got, _ = ttr.forward(cfg_t, pt, torch.from_numpy(toks))
        np.testing.assert_allclose(_t(got), _np(want), **tol)
    elif path == "slot_ring":
        lj, cache_j = jtr.prefill(cfg_j, pj, jnp.asarray(toks[:, :10]),
                                  max_len=16)
        lt, cache_t = ttr.prefill(cfg_t, pt, torch.from_numpy(toks[:, :10]),
                                  max_len=16)
        np.testing.assert_allclose(_t(lt), _np(lj), **tol)
        lj, _ = jtr.decode_step(cfg_j, pj, cache_j, jnp.asarray(toks[:, 10]),
                                jnp.asarray(10, jnp.int32))
        lt, _ = ttr.decode_step(cfg_t, pt, cache_t,
                                torch.from_numpy(toks[:, 10]), 10)
        np.testing.assert_allclose(_t(lt), _np(lj), **tol)
    else:
        shape = (cfg_t.n_layers, 8, 8, cfg_t.n_kv_heads, cfg_t.d_head)
        k = rng.standard_normal(shape, dtype=np.float32)
        v = rng.standard_normal(shape, dtype=np.float32)
        table = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
        q_off, lens = np.array([3, 0], np.int32), np.array([13, 10], np.int32)
        pool_j = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
        pool_t = {"k": torch.from_numpy(k.copy()),
                  "v": torch.from_numpy(v.copy())}
        lj, pool_j = jtr.prefill_chunk_paged(
            cfg_j, pj, pool_j, jnp.asarray(toks[:, :10]), jnp.asarray(table),
            jnp.asarray(q_off))
        lt = ttr.prefill_chunk_paged(
            cfg_t, pt, pool_t, torch.from_numpy(toks[:, :10]),
            torch.from_numpy(table), torch.from_numpy(q_off))
        np.testing.assert_allclose(_t(lt), _np(lj), **tol)
        lj, _ = jtr.decode_step_paged(
            cfg_j, pj, pool_j, jnp.asarray(toks[:, 10]), jnp.asarray(table),
            jnp.asarray(lens))
        lt = ttr.decode_step_paged(
            cfg_t, pt, pool_t, torch.from_numpy(toks[:, 10]),
            torch.from_numpy(table), torch.from_numpy(lens))
        np.testing.assert_allclose(_t(lt), _np(lj), **tol)


def test_registry_families():
    cfg = smoke_config(SSM)
    api = registry.get_api(cfg)
    assert api.init is tm.init
    assert (api.decode_step, api.init_cache) == (tm.decode_step,
                                                 tm.init_cache)
    _, _, _, pm = _params(SSM, "float32")
    toks = torch.from_numpy(np.arange(1, 13, dtype=np.int64)[None])
    for got, want in zip(api.prefill(cfg, pm, {"tokens": toks}),
                         tm.prefill(cfg, pm, toks)):
        for name in (want if isinstance(want, dict) else {"": want}):
            g, w = (got[name], want[name]) if name else (got, want)
            assert torch.equal(g, w), name
    dense = smoke_config(DENSE)
    assert registry.get_api(dense).init is ttr.init
    assert registry.get_api(smoke_config("zamba2-1.2b")).init is hybrid.init
    # encdec routes frames, vlm patches; moe and vlm share the
    # transformer's entries; an unknown family is refused
    assert registry.get_api(smoke_config("whisper-large-v3")).decode_step \
        is encdec.decode_step
    for family in ("vlm", "moe"):
        assert registry.get_api(cfg.replace(family=family)) is \
            registry.get_api(dense)
    with pytest.raises(ValueError, match="unknown model family 'rnn'"):
        registry.get_api(cfg.replace(family="rnn"))
    vlm = smoke_config("paligemma-3b").replace(dtype="float32")
    pv = ttr.init(vlm, torch.Generator().manual_seed(0), device="cpu")
    patched = {"tokens": torch.ones(1, 4, dtype=torch.long),
               "patches": torch.randn(1, vlm.prefix_len, vlm.d_model,
                                      generator=torch.Generator()
                                      .manual_seed(1))}
    logits, _ = registry.get_api(vlm).forward(vlm, pv, patched)
    want, _ = ttr.forward(vlm, pv, patched["tokens"],
                          patches=patched["patches"])
    assert logits.shape[1] == vlm.prefix_len + 4 and torch.equal(logits, want)
    last, cache = registry.get_api(vlm).prefill(vlm, pv, patched, max_len=32)
    torch.testing.assert_close(last, want[:, -1], atol=1e-5, rtol=1e-5)
    assert cache["lens"].tolist() == [vlm.prefix_len + 4]
    assert SSM in ARCHS and "paligemma-3b" in ARCHS


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 7, 11), dtype=np.float32) * 3
    labels = rng.integers(0, 11, size=(2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = steps.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  None if m is None else torch.from_numpy(m))
        want = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _batch(cfg, B, L, step=0):
    raw = jax_pipeline.make_dataset("synthetic", cfg, L, B).batch(step)
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v) for k, v in raw.items()})


@pytest.mark.parametrize("arch,L", [(SSM, 96), (SSM, 70), (DENSE, 32)])
def test_loss_and_grads_match_jax(arch, L):
    cfg_j, cfg_t, pj, pt = _params(arch, "float32")
    bj, bt = _batch(cfg_t, 2, L)
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jsteps.loss_fn(cfg_j, p, bj), has_aux=True)(pj)
    params = _clone(pt)
    for p in _flat(params).values():
        p.requires_grad_(True)
    loss_t, metrics = steps.loss_fn(cfg_t, params, bt)
    grads_t = steps.grads_of(loss_t, params)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    assert metrics["ce"].item() == loss_t.item()
    gj, gt = _flat(grads_j), _flat(grads_t)
    assert sorted(gj) == sorted(gt)
    for name in gj:
        np.testing.assert_allclose(_t(gt[name]), _np(gj[name]),
                                   err_msg=name, **GRAD_TOL)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    """Stacked [L, ...] matrices and vectors, a plain matrix and an
    unstacked vector."""
    shapes = {"layers": {"w": (3, 6, 5), "scale": (3, 5)},
              "embed": {"table": (9, 5)}, "final_norm": {"scale": (5,)}}
    return {g: {k: rng.standard_normal(s, dtype=np.float32)
                for k, s in leaves.items()} for g, leaves in shapes.items()}


def test_lr_schedule_and_global_norm_match_jax():
    cfg = jopt.OptimizerConfig(lr=3e-4, warmup_steps=10, decay_steps=100)
    tcfg = topt.OptimizerConfig(lr=3e-4, warmup_steps=10, decay_steps=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 250):
        np.testing.assert_allclose(
            topt.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32)).item(),
            float(jopt.lr_schedule(cfg, jnp.asarray(s, jnp.int32))), rtol=1e-6)
    tree = _opt_tree(np.random.default_rng(6))
    np.testing.assert_allclose(
        topt.global_norm(jax.tree_util.tree_map(torch.from_numpy, tree)).item(),
        float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))),
        rtol=1e-6)


@pytest.mark.parametrize("zero_grads", [False, True])
def test_optimizer_update_matches_jax(zero_grads):
    """Three AdamW steps on both sides, clip active on the first. With
    zero gradients only the weight decay moves a leaf: the stacked
    per-layer vectors decay (ndim 2 as stacked), the unstacked
    ``final_norm`` does not (ROADMAP.md, C)."""
    rng = np.random.default_rng(7)
    params = _opt_tree(rng)
    grads = [jax.tree_util.tree_map(
        lambda p, s=s: (0 * p if zero_grads else
                        rng.standard_normal(p.shape, dtype=np.float32) * s),
        params) for s in (10.0, 0.1, 0.01)]
    cfg = dict(lr=1e-2, warmup_steps=2, decay_steps=20)
    oj, ot = jopt.Optimizer(jopt.OptimizerConfig(**cfg)), \
        topt.Optimizer(topt.OptimizerConfig(**cfg))
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    pt = jax.tree_util.tree_map(torch.from_numpy, params)
    pt = _clone(pt)
    sj, st = oj.init(pj), ot.init(pt)
    for g in grads:
        pj, sj, mj = oj.update(pj, jax.tree_util.tree_map(jnp.asarray, g), sj)
        pt, st, mt = ot.update(pt, jax.tree_util.tree_map(torch.from_numpy, g),
                               st)
        for k in ("grad_norm", "lr", "step"):
            np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=1e-6)
    assert int(st["step"]) == int(sj["step"]) == 3
    for tree_t, tree_j in ((pt, pj), (st["m"], sj["m"]), (st["v"], sj["v"])):
        ft, fj = _flat(tree_t), _flat(tree_j)
        for name in fj:
            np.testing.assert_allclose(_t(ft[name]), _np(fj[name]),
                                       atol=1e-7, rtol=1e-6, err_msg=name)
    if zero_grads:
        assert not np.array_equal(_t(pt["layers"]["scale"]),
                                  params["layers"]["scale"])
        np.testing.assert_array_equal(_t(pt["final_norm"]["scale"]),
                                      params["final_norm"]["scale"])


def test_optimizer_updates_in_place():
    rng = np.random.default_rng(8)
    params = _clone(jax.tree_util.tree_map(torch.from_numpy, _opt_tree(rng)))
    opt = topt.Optimizer()
    state = opt.init(params)
    w, m = params["layers"]["w"], state["m"]["layers"]["w"]
    grads = jax.tree_util.tree_map(torch.ones_like, params)
    new_params, new_state, _ = opt.update(params, grads, state)
    assert new_params["layers"]["w"] is w and new_state["m"]["layers"]["w"] is m
    assert m.abs().sum() > 0


# ---------------------------------------------------------------------------
# train steps in lockstep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,L", [(SSM, 96), (DENSE, 32)])
def test_train_step_lockstep_with_jax(arch, L):
    """Three steps of ``make_train_step`` in float32 from the same
    params and batches: loss, grad norm and lr every step, every param
    after the last."""
    cfg_j, cfg_t, pj, pt = _params(arch, "float32")
    ocfg = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
    opt_j = jopt.Optimizer(jopt.OptimizerConfig(**ocfg))
    opt_t = topt.Optimizer(topt.OptimizerConfig(**ocfg))
    step_j = jax.jit(jsteps.make_train_step(cfg_j, opt_j))
    step_t = steps.make_train_step(cfg_t, opt_t)
    params_j, state_j = pj, opt_j.init(pj)
    params_t = _clone(pt)
    state_t = opt_t.init(params_t)
    for s in range(3):
        bj, bt = _batch(cfg_t, 2, L, step=s)
        params_j, state_j, mj = step_j(params_j, state_j, bj)
        params_t, state_t, mt = step_t(params_t, state_t, bt)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=1e-5,
                                       err_msg=f"step {s} {k}")
    fj, ft = _flat(params_j), _flat(params_t)
    for name in fj:
        got, want = _t(ft[name]), _np(fj[name])
        tight = np.abs(got - want) <= 2e-6 + 1e-5 * np.abs(want)
        assert tight.mean() >= 0.999, (name, tight.mean())
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# data, checkpoints, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["synthetic", "corpus"])
def test_dataset_batches_match_jax(name):
    cfg = smoke_config(DENSE)
    ours = pipeline.make_dataset(name, cfg, 48, 3)
    theirs = jax_pipeline.make_dataset(name, cfg, 48, 3)
    for step, rank in ((0, 0), (1, 0), (7, 1), (123, 3)):
        a, b = ours.batch(step, rank), theirs.batch(step, rank)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


def test_checkpoint_round_trip_keeps_bf16_bits(tmp_path):
    _, _, _, pt = _params(SSM, "bfloat16")
    opt = topt.Optimizer()
    state = {"params": pt, "opt": opt.init(pt)}
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(5, state, scheduler_state={"bias": {"a": 1.5}})
    step, got, sched = mgr.restore(state)
    assert step == 5 and sched == {"bias": {"a": 1.5}}
    want, have = _flat(state), _flat(got)
    assert sorted(want) == sorted(have)
    for name in want:
        assert have[name].dtype == want[name].dtype, name
        assert torch.equal(have[name], want[name]), name
    assert have["params/layers/ssm/A_log"].dtype == torch.float32
    assert have["params/layers/ssm/w_x"].dtype == torch.bfloat16


def test_checkpoints_interchange_with_jax_in_float32(tmp_path):
    _, _, pj, pt = _params(SSM, "float32")
    ours = CheckpointManager(str(tmp_path / "port"), async_write=False)
    ours.save(3, {"params": pt})
    theirs = JaxCheckpoints(str(tmp_path / "port"), async_write=False)
    step, got_j, _ = theirs.restore({"params": pj})
    assert step == 3
    for name, leaf in _flat(got_j).items():
        np.testing.assert_array_equal(np.asarray(leaf),
                                      _t(_flat({"params": pt})[name]))
    theirs = JaxCheckpoints(str(tmp_path / "jax"), async_write=False)
    theirs.save(4, {"params": pj})
    step, got_t, _ = CheckpointManager(str(tmp_path / "jax")).restore(
        {"params": pt})
    assert step == 4
    for name, leaf in _flat({"params": pj}).items():
        np.testing.assert_array_equal(_t(_flat(got_t)[name]), np.asarray(leaf))


def test_checkpoint_keep_collects_old_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((2,), float(s))})
    mgr.wait()
    assert mgr.list_steps() == [3, 4] and mgr.latest_step() == 4
    _, got, _ = mgr.restore({"w": torch.zeros(2)}, step=3)
    assert got["w"].tolist() == [3.0, 3.0]
    (tmp_path / "step_00000009.tmp").mkdir()     # a crashed write
    assert mgr.latest_step() == 4


LOG_LINE = re.compile(r"^step +\d+ loss=\d+\.\d{4} gnorm=\d+\.\d{3} "
                      r"lr=\d\.\d{2}e[-+]\d{2} \(\d+\.\d{2}s/step\)$")


@pytest.mark.parametrize("arch,seq", [(SSM, 96), (DENSE, 32),
                                      ("grok-1-314b", 32),
                                      ("paligemma-3b", 32)])
def test_launcher_trains_and_resumes_on_cpu(arch, seq, tmp_path, capsys):
    common = ["--device", "cpu", "--arch", arch, "--preset", "smoke",
              "--seq", str(seq), "--batch", "2", "--log-every", "1",
              "--checkpoint-dir", str(tmp_path)]
    assert launch_train.main(common + ["--steps", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch}-smoke params=")
    logs = [line for line in out if line.startswith("step")]
    assert len(logs) == 2 and all(LOG_LINE.match(line) for line in logs)
    assert all(np.isfinite(float(line.split("loss=")[1].split()[0]))
               for line in logs)
    assert launch_train.main(common + ["--steps", "4", "--resume"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "resumed from step 2" in out
    assert [line.split()[1] for line in out if line.startswith("step")] == \
        ["2", "3"]
    assert CheckpointManager(str(tmp_path)).latest_step() == 4


def test_launcher_refuses_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", SSM, "--steps", "1"])
