"""The port's zamba2-style hybrid against JAX, on the CPU.

* ``hybrid.init``: the port's tree has JAX's keys, shapes and dtypes;
  ``bridge.params_from_numpy`` carries the ``shared`` subtree across
  bit for bit.
* ``hybrid.forward`` logits at L 24 and 40 (past the smoke window of
  16, so the window masks), and one loss and its gradients.
* ``hybrid.prefill`` at L 12 (under the window: the rings are
  zero-padded), 32 and 40 (over it: the rings are rolled), with every
  cache leaf compared, then decode steps past the window (the ring
  wraps during decode).
* The slot-ring engine on ``smoke_config("zamba2-1.2b")`` in lockstep
  with the JAX engine, buckets 16 and 32 (a 32-token prompt rolls the
  16-entry ring), chunk budget None and 8.
* The training launcher on the smoke config, through
  ``get_api(cfg).forward``, and one launcher train step's loss and grad
  norm against JAX's ``make_train_step`` on the same params and batch.

Weights come from the JAX ``hybrid.init(PRNGKey(0))`` through
``bridge.params_from_numpy``. JAX runs on the CPU, its attention and
SSD through their plain forms (``impl='auto'`` off the TPU), as the
port's plain versions do.

Tolerances: float32 ``atol=rtol=1e-5`` on logits and caches (the same
float32 math in another summation order, four Mamba layers and two
shared-block applications deep), gradients ``atol=1e-6, rtol=1e-4``
and loss / grad norm ``rtol=1e-5``, as ``test_torch_train.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.distributed import optimizer as jopt
from repro.models import hybrid as jh
from repro.models import steps as jsteps
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.launch import train as launch_train
from repro_torch.models import hybrid as th
from repro_torch.models import steps

from test_torch_ssm_serving import run_lockstep

ARCH = "zamba2-1.2b"
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _params(dtype="float32"):
    """(jax cfg, port cfg, jax params, port params); read-only."""
    cfg_j = jax_smoke_config(ARCH).replace(dtype=dtype)
    cfg_t = smoke_config(ARCH).replace(dtype=dtype)
    pj = jh.init(cfg_j, jax.random.PRNGKey(0))
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


def _assert_cache_close(ct, cj, msg=""):
    assert sorted(ct) == sorted(cj)
    for name in cj:
        assert tuple(ct[name].shape) == tuple(cj[name].shape), name
        np.testing.assert_allclose(_t(ct[name]), _np(cj[name]),
                                   err_msg=f"{msg} {name}", **TOL)


def test_init_tree_matches_jax_keys_shapes_and_dtypes():
    cfg_j, _, pj, _ = _params("bfloat16")
    cfg = smoke_config(ARCH)
    pt = th.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    fj, ft = _flat(pj), _flat(pt)
    assert sorted(fj) == sorted(ft)
    for name in fj:
        assert tuple(ft[name].shape) == tuple(fj[name].shape), name
        assert str(ft[name].dtype).split(".")[-1] == str(fj[name].dtype), name
    w = 2 * cfg.d_model
    assert tuple(ft["shared/attn/wq"].shape) == (w, cfg.n_heads, cfg.d_head)
    assert tuple(ft["shared/down"].shape) == (w, cfg.d_model)
    assert ft["shared/attn/wq"].float().std().item() == pytest.approx(
        w ** -0.5, rel=0.2)


def test_bridge_carries_the_shared_subtree_bit_for_bit():
    _, _, pj, pt = _params("bfloat16")
    fj, ft = _flat(pj["shared"]), _flat(pt["shared"])
    assert sorted(fj) == sorted(ft) == [
        "attn/wk", "attn/wo", "attn/wq", "attn/wv", "down", "ln1/scale",
        "ln2/scale", "mlp/w1", "mlp/w2", "mlp/w3"]
    for name in fj:
        assert ft[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(_t(ft[name]), _np(fj[name]),
                                      err_msg=name)


@pytest.mark.parametrize("L", [24, 40])
def test_forward_matches_jax(L):
    cfg_j, cfg_t, pj, pt = _params()
    tj, tt = _tokens(cfg_t, 2, L, seed=L)
    lj, _ = jh.forward(cfg_j, pj, tj)
    lt, aux = th.forward(cfg_t, pt, tt)
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL)
    assert aux.item() == 0.0


def test_loss_and_grads_match_jax():
    cfg_j, cfg_t, pj, pt = _params()
    raw = jax_pipeline.make_dataset("synthetic", cfg_t, 40, 2).batch(0)
    bj = {k: jnp.asarray(v) for k, v in raw.items()}
    bt = {k: torch.from_numpy(v) for k, v in raw.items()}
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jsteps.loss_fn(cfg_j, p, bj), has_aux=True)(pj)
    params = _clone(pt)
    for p in _flat(params).values():
        p.requires_grad_(True)
    loss_t, _ = steps.loss_fn(cfg_t, params, bt)
    grads_t = steps.grads_of(loss_t, params)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    gj, gt = _flat(grads_j), _flat(grads_t)
    assert sorted(gj) == sorted(gt)
    for name in gj:
        np.testing.assert_allclose(_t(gt[name]), _np(gj[name]),
                                   err_msg=name, **GRAD_TOL)


def test_init_cache_matches_jax():
    cfg_j, cfg_t, _, _ = _params("bfloat16")
    cj = jh.init_cache(cfg_j, 3, 96)
    ct = th.init_cache(cfg_t, 3, 96, device="cpu")
    assert sorted(ct) == sorted(cj)
    for name in cj:
        assert tuple(ct[name].shape) == tuple(cj[name].shape), name
        assert str(ct[name].dtype).split(".")[-1] == str(cj[name].dtype), name
    # one ring per application of the shared block, window-sized
    assert tuple(ct["attn_k"].shape) == (2, 3, 16, cfg_t.n_kv_heads,
                                         cfg_t.d_head)


@pytest.mark.parametrize("L,steps_", [(12, 8), (32, 4), (40, 4)])
def test_prefill_then_decode_steps_match_jax(L, steps_):
    """Prefill's last logits and every cache leaf (rings padded under
    the window, rolled over it), then decode steps: L 12 + 8 steps
    wraps the ring during decode."""
    cfg_j, cfg_t, pj, pt = _params()
    tj, tt = _tokens(cfg_t, 2, L + steps_, seed=L + 1)
    lj, cj = jh.prefill(cfg_j, pj, tj[:, :L], max_len=96)
    lt, ct = th.prefill(cfg_t, pt, tt[:, :L], max_len=96)
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL)
    _assert_cache_close(ct, cj, "prefill")
    for s in range(steps_):
        lj, cj = jh.decode_step(cfg_j, pj, cj, tj[:, L + s], cj["lens"])
        lt, ct = th.decode_step(cfg_t, pt, ct, tt[:, L + s], ct["lens"])
        np.testing.assert_allclose(_t(lt), _np(lj), err_msg=f"step {s}", **TOL)
        _assert_cache_close(ct, cj, f"step {s}")
    assert ct["lens"].tolist() == [L + steps_] * 2


@pytest.mark.parametrize("chunk", [None, 8])
def test_zamba2_slot_ring_engine_lockstep_with_jax(chunk):
    cfg_j, cfg_t, pj, pt = _params()
    te = run_lockstep(cfg_j, cfg_t, pj, pt, n_slots=3, max_len=96,
                      prompt_buckets=(16, 32), chunk_prefill_tokens=chunk)
    assert sorted(te.cache) == ["attn_k", "attn_v", "conv", "lens", "ssm"]
    assert te.cache["attn_k"].shape[2] == cfg_t.sliding_window


def test_launcher_trains_zamba2_through_the_registry(monkeypatch, capsys):
    calls = []
    forward = th.forward

    def counted(*a, **kw):
        calls.append(1)
        return forward(*a, **kw)
    monkeypatch.setattr(th, "forward", counted)
    assert launch_train.main(["--device", "cpu", "--arch", ARCH, "--preset",
                              "smoke", "--seq", "40", "--batch", "2",
                              "--steps", "2", "--log-every", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={ARCH}-smoke params=")
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert len(calls) == 2          # one forward per step, via the registry


def test_launcher_train_step_matches_jax():
    """One step of the launcher's ``build`` on the bridged params
    against JAX's ``make_train_step``: loss, grad norm and lr."""
    cfg_j, cfg_t, pj, pt = _params()
    params, opt, _, step_t = launch_train.build(cfg_t, steps=10, lr=1e-3,
                                                seed=0, device="cpu")
    assert sorted(_flat(params)) == sorted(_flat(pt))
    params = _clone(pt)
    opt_j = jopt.Optimizer(jopt.OptimizerConfig(lr=1e-3, warmup_steps=10,
                                                decay_steps=100))
    raw = jax_pipeline.make_dataset("synthetic", cfg_t, 40, 2).batch(0)
    _, _, mj = jax.jit(jsteps.make_train_step(cfg_j, opt_j))(
        pj, opt_j.init(pj), {k: jnp.asarray(v) for k, v in raw.items()})
    _, _, mt = step_t(params, opt.init(params),
                      {k: torch.from_numpy(v) for k, v in raw.items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=1e-5,
                                   err_msg=k)
