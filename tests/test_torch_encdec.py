"""The port's encoder-decoder (whisper-large-v3) against JAX, on the CPU.

* ``encdec.init``: the port's tree has JAX's keys, shapes and dtypes.
* ``layers.sinusoidal_positions`` and ``sinusoidal_at`` against JAX's.
* ``encdec.encode``; ``encdec.forward`` logits at L 12 and 40 (40 is
  past the smoke ``enc_seq`` of 16, so cross-attention has more queries
  than keys); one loss and its gradients.
* ``encdec.prefill`` at L 12 and 32 with every cache leaf compared,
  then three ``decode_step``s.
* The slot-ring engine on ``smoke_config("whisper-large-v3")`` in
  lockstep with the JAX engine, buckets 16 and 32 (a 32-token bucket
  cross-attends 16 frames), chunk budget None and 8; the paged engine
  refuses the family in both packages.
* The training launcher: its batch carries JAX's stub frames, and one
  launcher train step's loss and grad norm equal JAX's on the same
  batch and frames.

Weights come from the JAX ``encdec.init(PRNGKey(0))`` through
``bridge.params_from_numpy``. JAX runs on the CPU, its attention
through the plain form (``attn_impl='auto'`` off the TPU), as the
port's plain versions do.

Tolerances (``tests/test_torch_hybrid.py``'s): float32 ``atol=rtol=1e-5``
on logits and caches (the same float32 math in another summation
order, two encoder and two decoder layers deep), gradients
``atol=1e-6, rtol=1e-4``, loss and grad norm ``rtol=1e-5``. Sinusoidal
rows: ``atol=1e-6`` at smoke size; at whisper's 1,500 x 1,280 the
angles reach 1,499 radians, where one float32 ulp of an angle is
``2**-13`` and the two frameworks' ``pow`` and ``sin`` may each round
differently, so ``atol=2**-13`` there.
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
from repro.distributed import optimizer as jopt
from repro.models import encdec as je
from repro.models import layers as jl
from repro.models import steps as jsteps
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core.scheduler import DriftScheduler
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import encdec as te
from repro_torch.models import layers as tl
from repro_torch.models import registry, steps
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator

from test_torch_ssm_serving import run_lockstep

ARCH = "whisper-large-v3"
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _params(dtype="float32"):
    """(jax cfg, port cfg, jax params, port params); read-only."""
    cfg_j = jax_smoke_config(ARCH).replace(dtype=dtype)
    cfg_t = smoke_config(ARCH).replace(dtype=dtype)
    pj = je.init(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(cfg_t, jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfg_j, cfg_t, pj, pt


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.detach().float().numpy()


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


def _tokens(cfg, B, L, seed):
    toks = np.random.default_rng(seed).integers(
        1, cfg.vocab, size=(B, L)).astype(np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks)


def _frames(cfg, B, seed):
    """The stub frontend's output as the launchers draw it."""
    fr = jax_pipeline.attach_modality_stubs(
        cfg, {"tokens": np.zeros((B, 1), np.int32)},
        np.random.default_rng(seed))["frames"]
    return jnp.asarray(fr), torch.from_numpy(fr)


def _assert_cache_close(ct, cj, msg=""):
    assert sorted(ct) == sorted(cj)
    for name in cj:
        assert tuple(ct[name].shape) == tuple(cj[name].shape), name
        np.testing.assert_allclose(_t(ct[name]), _np(cj[name]),
                                   err_msg=f"{msg} {name}", **TOL)


def test_init_tree_matches_jax_keys_shapes_and_dtypes():
    cfg_j, _, pj, _ = _params("bfloat16")
    cfg = smoke_config(ARCH)
    pt = te.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    fj, ft = _flat(pj), _flat(pt)
    assert sorted(fj) == sorted(ft)
    for name in fj:
        assert tuple(ft[name].shape) == tuple(fj[name].shape), name
        assert str(ft[name].dtype).split(".")[-1] == str(fj[name].dtype), name
    assert "lm_head" not in pt                     # tied embeddings
    assert tuple(ft["enc_layers/attn/wq"].shape) == (
        cfg.n_enc_layers, cfg.d_model, cfg.n_heads, cfg.d_head)
    assert tuple(ft["dec_layers/cross_attn/attn/wk"].shape) == (
        cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.d_head)
    assert torch.all(ft["dec_layers/lnx/scale"] == 1)
    assert not ft["enc_norm/bias"].any()
    assert ft["dec_layers/mlp/w1"].float().std().item() == pytest.approx(
        cfg.d_model ** -0.5, rel=0.2)


@pytest.mark.parametrize("L,d,atol", [(40, 64, 1e-6), (1500, 1280, 2 ** -13)])
def test_sinusoidal_positions_match_jax(L, d, atol):
    np.testing.assert_allclose(tl.sinusoidal_positions(L, d, "cpu").numpy(),
                               _np(jl.sinusoidal_positions(L, d)),
                               atol=atol, rtol=0)
    pos = np.array([0, 3, L - 1], np.int32)
    np.testing.assert_allclose(
        tl.sinusoidal_at(torch.from_numpy(pos), d, "cpu").numpy(),
        _np(jl.sinusoidal_at(jnp.asarray(pos), d)), atol=atol, rtol=0)
    np.testing.assert_allclose(tl.sinusoidal_at(7, d, "cpu").numpy(),
                               _np(jl.sinusoidal_at(7, d)), atol=atol, rtol=0)


def test_encode_matches_jax():
    cfg_j, cfg_t, pj, pt = _params()
    fj, ft = _frames(cfg_t, 2, seed=1)
    got = te.encode(cfg_t, pt, ft)
    assert tuple(got.shape) == (2, cfg_t.enc_seq, cfg_t.d_model)
    np.testing.assert_allclose(_t(got), _np(je.encode(cfg_j, pj, fj)), **TOL)


@pytest.mark.parametrize("L", [12, 40])
def test_forward_matches_jax(L):
    cfg_j, cfg_t, pj, pt = _params()
    tj, tt = _tokens(cfg_t, 2, L, seed=L)
    fj, ft = _frames(cfg_t, 2, seed=L)
    lj, _ = je.forward(cfg_j, pj, tj, frames=fj)
    lt, aux = te.forward(cfg_t, pt, tt, frames=ft)
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL)
    assert aux.item() == 0.0


def test_loss_and_grads_match_jax():
    cfg_j, cfg_t, pj, pt = _params()
    raw = jax_pipeline.attach_modality_stubs(
        cfg_t, jax_pipeline.make_dataset("synthetic", cfg_t, 40, 2).batch(0),
        np.random.default_rng(0))
    bj = {k: jnp.asarray(v) for k, v in raw.items()}
    bt = {k: torch.from_numpy(v) for k, v in raw.items()}
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jsteps.loss_fn(cfg_j, p, bj), has_aux=True)(pj)
    params = _clone(pt)
    for p in _flat(params).values():
        p.requires_grad_(True)
    loss_t, _ = steps.loss_fn(cfg_t, params, bt, remat=True)
    grads_t = steps.grads_of(loss_t, params)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    gj, gt = _flat(grads_j), _flat(grads_t)
    assert sorted(gj) == sorted(gt)
    for name in gj:
        np.testing.assert_allclose(_t(gt[name]), _np(gj[name]),
                                   err_msg=name, **GRAD_TOL)


def test_init_cache_matches_jax():
    cfg_j, cfg_t, _, _ = _params("bfloat16")
    cj = je.init_cache(cfg_j, 3, 96)
    ct = te.init_cache(cfg_t, 3, 96, device="cpu")
    assert sorted(ct) == sorted(cj)
    for name in cj:
        assert tuple(ct[name].shape) == tuple(cj[name].shape), name
        assert str(ct[name].dtype).split(".")[-1] == str(cj[name].dtype), name
        assert not ct[name].any(), name
    assert ct["cross_k"].shape[2] == cfg_t.enc_seq


@pytest.mark.parametrize("L", [12, 32])
def test_prefill_then_decode_steps_match_jax(L):
    """Prefill's last logits and every cache leaf (self K/V padded to
    ``max_len``, the cross K/V), then three decode steps: each step's
    logits and the whole cache after it (the cross K/V unchanged)."""
    cfg_j, cfg_t, pj, pt = _params()
    tj, tt = _tokens(cfg_t, 2, L + 3, seed=L + 1)
    fj, ft = _frames(cfg_t, 2, seed=L + 2)
    lj, cj = je.prefill(cfg_j, pj, tj[:, :L], frames=fj, max_len=64)
    lt, ct = te.prefill(cfg_t, pt, tt[:, :L], frames=ft, max_len=64)
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL)
    _assert_cache_close(ct, cj, "prefill")
    cross = ct["cross_k"].clone()
    for s in range(3):
        lj, cj = je.decode_step(cfg_j, pj, cj, tj[:, L + s], cj["lens"])
        lt, ct = te.decode_step(cfg_t, pt, ct, tt[:, L + s], ct["lens"])
        np.testing.assert_allclose(_t(lt), _np(lj), err_msg=f"step {s}", **TOL)
        _assert_cache_close(ct, cj, f"step {s}")
    assert ct["lens"].tolist() == [L + 3] * 2
    assert torch.equal(ct["cross_k"], cross)


def test_decode_step_writes_the_self_cache_in_place():
    _, cfg, _, pt = _params()
    cache = te.init_cache(cfg, 2, 16, device="cpu")
    k = cache["k"]
    _, out = te.decode_step(cfg, pt, cache, torch.tensor([3, 4]),
                            cache["lens"])
    assert out["k"] is k and k[:, :, 0].any() and not k[:, :, 1:].any()
    assert out["lens"].tolist() == [1, 1]


@pytest.mark.parametrize("chunk", [None, 8])
def test_whisper_slot_ring_engine_lockstep_with_jax(chunk):
    cfg_j, cfg_t, pj, pt = _params()
    te_ = run_lockstep(cfg_j, cfg_t, pj, pt, n_slots=3, max_len=96,
                       prompt_buckets=(16, 32), chunk_prefill_tokens=chunk)
    assert sorted(te_.cache) == ["cross_k", "cross_v", "k", "lens", "v"]
    assert te_.cache["cross_k"].shape[2] == cfg_t.enc_seq


def test_engine_batch_carries_zero_frames():
    """Admission builds the stub frontend's zero frames beside the
    prompt, as the JAX engine does, and the prefill routes them."""
    _, cfg, _, pt = _params()
    sched = DriftScheduler("fifo")
    eng = ServingEngine(cfg, pt, sched, EngineConfig(
        n_slots=1, max_len=64, prompt_buckets=(32,),
        chunk_prefill_tokens=4), device="cpu")
    (t, req), = WorkloadGenerator(GeneratorConfig(
        total_requests=1, calibration_requests=1, seed=3)).plan(
            seed=3).calibration
    sched.submit(req, t)
    eng.step(0.0)
    batch = eng.slots[0].batch
    assert sorted(batch) == ["frames", "tokens"]
    assert tuple(batch["frames"].shape) == (1, cfg.enc_seq, cfg.d_model)
    assert batch["frames"].dtype == torch.bfloat16 and not batch["frames"].any()
    assert int(batch["tokens"].max()) < cfg.vocab


def test_paged_engine_refuses_encdec_in_both_packages():
    cfg_j, cfg_t, pj, pt = _params()
    with pytest.raises(ValueError, match="transformer-family"):
        JaxEngine(cfg_j, pj, JaxScheduler("fifo"), JaxEngineConfig(paged=True))
    with pytest.raises(ValueError, match="transformer-family") as got:
        ServingEngine(cfg_t, pt, DriftScheduler("fifo"),
                      EngineConfig(paged=True), device="cpu")
    assert "'encdec'" in str(got.value)


def test_registry_routes_frames():
    cfg_j, cfg_t, pj, pt = _params()
    api = registry.get_api(cfg_t)
    assert (api.init, api.decode_step, api.init_cache) == (
        te.init, te.decode_step, te.init_cache)
    tj, tt = _tokens(cfg_t, 1, 12, seed=5)
    fj, ft = _frames(cfg_t, 1, seed=5)
    lt, ct = api.prefill(cfg_t, pt, {"tokens": tt, "frames": ft}, max_len=32)
    lj, cj = je.prefill(cfg_j, pj, tj, frames=fj, max_len=32)
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL)
    _assert_cache_close(ct, cj)
    assert ARCH in ARCHS


def test_launcher_batch_carries_jax_stub_frames():
    """The launcher's batches draw the frames from one
    ``default_rng(0)``, once a step, in JAX's order."""
    cfg = smoke_config(ARCH)
    ds = jax_pipeline.make_dataset("synthetic", cfg, 40, 2)
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    for step in range(2):
        want = jax_pipeline.attach_modality_stubs(cfg, ds.batch(step), rng_j)
        got = launch_train.batch_on(cfg, ds, step, rng_t, "cpu")
        assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_launcher_trains_whisper(capsys):
    assert launch_train.main(["--device", "cpu", "--arch", ARCH, "--preset",
                              "smoke", "--seq", "40", "--batch", "2",
                              "--steps", "3", "--log-every", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={ARCH}-smoke params=")
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_launcher_train_step_matches_jax():
    """One step of the launcher's ``build`` on the bridged params
    against JAX's ``make_train_step``: loss, grad norm and lr, on the
    same batch and stub frames."""
    cfg_j, cfg_t, pj, pt = _params()
    params, opt, _, step_t = launch_train.build(cfg_t, steps=10, lr=1e-3,
                                                seed=0, device="cpu")
    assert sorted(_flat(params)) == sorted(_flat(pt))
    params = _clone(pt)
    opt_j = jopt.Optimizer(jopt.OptimizerConfig(lr=1e-3, warmup_steps=10,
                                                decay_steps=100))
    ds = jax_pipeline.make_dataset("synthetic", cfg_t, 40, 2)
    raw = jax_pipeline.attach_modality_stubs(cfg_t, ds.batch(0),
                                             np.random.default_rng(0))
    _, _, mj = jax.jit(jsteps.make_train_step(cfg_j, opt_j))(
        pj, opt_j.init(pj), {k: jnp.asarray(v) for k, v in raw.items()})
    batch = launch_train.batch_on(cfg_t, ds, 0, np.random.default_rng(0),
                                  "cpu")
    _, _, mt = step_t(params, opt.init(params), batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=1e-5,
                                   err_msg=k)


def test_serve_launcher_serves_whisper(monkeypatch, capsys):
    monkeypatch.setattr(launch_serve, "get_config", smoke_config)
    assert launch_serve.main(["--arch", ARCH, "--device", "cpu",
                              "--requests", "3", "--policy", "sjf"]) == 0
    assert "completed=3" in capsys.readouterr().out
    with pytest.raises(ValueError, match="transformer-family"):
        launch_serve.main(["--arch", ARCH, "--paged", "on", "--device",
                           "cpu", "--requests", "1"])
