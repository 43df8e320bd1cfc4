"""The port's Mamba-2 serving path against JAX, on the CPU.

* ``ops.ssm_decode_step`` against ``repro.kernels.ref.ssm_decode_step_ref``
  at 1 and 2 groups, float32 and bfloat16, on numpy inputs from a seed.
* ``mamba2.init_cache``'s leaves (shapes and dtypes) against JAX's.
* ``mamba2.prefill``: the last-position logits and every cache leaf
  (conv ring, SSM state, lens) at L 16 (one chunk of the smoke config's
  32) and 40 (a ragged second chunk), then four ``decode_step``s.
* The slot-ring engine on ``smoke_config("mamba2-2.7b")`` in lockstep
  with the JAX engine (chunk budget None and 8): every slot's last token
  and ``lens`` after every step, then completion records.
* ``paged=True`` on the ssm family raises ``ValueError`` in both
  packages, and so does the serving launcher's ``--paged on``; its
  slot-ring engine serves the mamba2 and zamba2 archs (smoke configs in
  place of the full widths the launcher builds).

Weights come from the JAX ``mamba2.init(PRNGKey(0))`` through
``bridge.params_from_numpy``; JAX runs on the CPU, where its prefill
calls ``ref.ssd_chunked`` and its decode ``ref.ssm_decode_step_ref``,
as the port does.

Tolerances: float32 ``atol=rtol=1e-5`` on logits and states (the same
float32 math summed in another order, two layers deep, as
``test_torch_train.py``'s Mamba-2 forward); the decode step alone
``atol=rtol=1e-6`` in float32; bfloat16 outputs of the decode step
``atol=rtol=1e-2`` (both compute in float32 and round once, so about
one bf16 ulp apart) and its float32 state ``1e-6``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.scheduler import DriftScheduler as JaxScheduler
from repro.kernels import ref as jref
from repro.models import mamba2 as jm
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxEngine
from repro.workload.generator import GeneratorConfig as JaxGeneratorConfig
from repro.workload.generator import WorkloadGenerator as JaxGenerator
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.core.scheduler import DriftScheduler
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mamba2 as tm
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator

ARCH = "mamba2-2.7b"
TOL = dict(atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _params(dtype="float32"):
    """(jax cfg, port cfg, jax params, port params); read-only."""
    cfg_j = jax_smoke_config(ARCH).replace(dtype=dtype)
    cfg_t = smoke_config(ARCH).replace(dtype=dtype)
    pj = jm.init(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(cfg_t, jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    return cfg_j, cfg_t, pj, pt


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return x.float().numpy()


def _tokens(cfg, B, L, seed):
    toks = np.random.default_rng(seed).integers(
        1, cfg.vocab, size=(B, L)).astype(np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks)


def _assert_cache_close(ct, cj, **tol):
    assert sorted(ct) == sorted(cj)
    for name in cj:
        assert tuple(ct[name].shape) == tuple(cj[name].shape), name
        np.testing.assert_allclose(_t(ct[name]), _np(cj[name]), err_msg=name,
                                   **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
def test_ssm_decode_step_matches_jax(G, dtype):
    rng = np.random.default_rng(11 + G)
    B, H, P, N = 3, 4, 8, 16
    h = rng.standard_normal((B, H, P, N), dtype=np.float32)
    x = rng.standard_normal((B, H, P), dtype=np.float32) * 0.5
    a = -np.abs(rng.standard_normal((B, H), dtype=np.float32)) * 0.1
    b = rng.standard_normal((B, G, N), dtype=np.float32) * 0.5
    c = rng.standard_normal((B, G, N), dtype=np.float32) * 0.5
    jdt = jnp.dtype(dtype)
    yj, hj = jref.ssm_decode_step_ref(
        jnp.asarray(h), *(jnp.asarray(t).astype(jdt) for t in (x, a, b, c)))
    yt, ht = ops.ssm_decode_step(
        torch.from_numpy(h),
        *(tensor_from_numpy(np.asarray(jnp.asarray(t).astype(jdt)),
                            device="cpu") for t in (x, a, b, c)))
    assert yt.dtype == getattr(torch, dtype) and ht.dtype == torch.float32
    assert tuple(yt.shape) == (B, H, P) and tuple(ht.shape) == (B, H, P, N)
    y_tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else \
        dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(_t(yt), _np(yj), **y_tol)
    np.testing.assert_allclose(ht.numpy(), _np(hj), atol=1e-6, rtol=1e-6)


def test_init_cache_matches_jax():
    cfg_j, cfg_t, _, _ = _params("bfloat16")
    cj = jm.init_cache(cfg_j, 3, 96)
    ct = tm.init_cache(cfg_t, 3, 96, device="cpu")
    assert sorted(ct) == sorted(cj)
    for name in cj:
        assert tuple(ct[name].shape) == tuple(cj[name].shape), name
        assert str(ct[name].dtype).split(".")[-1] == str(cj[name].dtype), name
        assert not ct[name].any(), name
    assert ct["conv"].dtype == torch.bfloat16
    assert ct["ssm"].dtype == torch.float32


@pytest.mark.parametrize("L", [16, 40])
def test_prefill_then_decode_steps_match_jax(L):
    """Prefill's last logits and every cache leaf, then four decode
    steps: each step's logits and the whole cache after it."""
    cfg_j, cfg_t, pj, pt = _params()
    tj, tt = _tokens(cfg_t, 2, L + 4, seed=L)
    lj, cj = jm.prefill(cfg_j, pj, tj[:, :L])
    lt, ct = tm.prefill(cfg_t, pt, tt[:, :L])
    np.testing.assert_allclose(_t(lt), _np(lj), **TOL)
    _assert_cache_close(ct, cj, **TOL)
    assert ct["lens"].tolist() == [L, L]
    for s in range(4):
        lj, cj = jm.decode_step(cfg_j, pj, cj, tj[:, L + s], cj["lens"])
        lt, ct = tm.decode_step(cfg_t, pt, ct, tt[:, L + s], ct["lens"])
        np.testing.assert_allclose(_t(lt), _np(lj), err_msg=f"step {s}", **TOL)
        _assert_cache_close(ct, cj, **TOL)
    assert ct["lens"].dtype == torch.int32


def test_decode_step_writes_the_states_in_place():
    _, cfg, _, pt = _params()
    cache = tm.init_cache(cfg, 2, 96, device="cpu")
    conv, ssm = cache["conv"], cache["ssm"]
    _, out = tm.decode_step(cfg, pt, cache, torch.tensor([3, 4]),
                            cache["lens"])
    assert out["conv"] is conv and out["ssm"] is ssm
    assert ssm.any() and conv.any()
    assert out["lens"].tolist() == [1, 1]


def _plans(n, seed, **kw):
    gk = dict(total_requests=n, calibration_requests=n, seed=seed, **kw)
    jr = [r for _, r in JaxGenerator(JaxGeneratorConfig(**gk))
          .plan(seed=seed).calibration]
    tr = [r for _, r in WorkloadGenerator(GeneratorConfig(**gk))
          .plan(seed=seed).calibration]
    return jr, tr


def _record(reqs, sched):
    idx = {r.req_id: i for i, r in enumerate(reqs)}
    return [(idx[r.req_id], r.observed_output_tokens, r.prefill_end,
             r.exec_end) for r in sched.completed]


def run_lockstep(cfg_j, cfg_t, pj, pt, **kw):
    """The JAX and the port's slot-ring engines stepped together on the
    same requests: every slot's last token and cache depth after every
    step, then the completion records. Returns the port's engine."""
    js, ts = JaxScheduler("fifo"), DriftScheduler("fifo")
    je = JaxEngine(cfg_j, pj, js, JaxEngineConfig(**kw))
    te = ServingEngine(cfg_t, pt, ts, EngineConfig(**kw), device="cpu")
    jr, tr = _plans(8, seed=3, max_tokens=12)
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
        assert te.active_slots() == je.active_slots()
        assert te.cache["lens"].tolist() == \
            np.asarray(je.cache["lens"]).tolist(), f"step {now}"
        now += 1.0
    assert not ts.queue_depth() and not te.active_slots()
    assert len(ts.completed) == len(tr)
    assert _record(tr, ts) == _record(jr, js)
    assert te.step_count == je.step_count
    return te


@pytest.mark.parametrize("chunk", [None, 8])
def test_mamba2_slot_ring_engine_lockstep_with_jax(chunk):
    cfg_j, cfg_t, pj, pt = _params()
    te = run_lockstep(cfg_j, cfg_t, pj, pt, n_slots=3, max_len=96,
                      prompt_buckets=(32, 64), chunk_prefill_tokens=chunk)
    assert sorted(te.cache) == ["conv", "lens", "ssm"]
    assert te.n_prefill_launches == 0


def test_paged_engine_refuses_ssm_in_both_packages():
    cfg_j, cfg_t, pj, pt = _params()
    with pytest.raises(ValueError, match="transformer-family"):
        JaxEngine(cfg_j, pj, JaxScheduler("fifo"), JaxEngineConfig(paged=True))
    with pytest.raises(ValueError, match="transformer-family") as got:
        ServingEngine(cfg_t, pt, DriftScheduler("fifo"),
                      EngineConfig(paged=True), device="cpu")
    assert "'ssm'" in str(got.value)


def test_serve_launcher_refuses_paged_ssm(monkeypatch):
    monkeypatch.setattr(launch_serve, "get_config", smoke_config)
    with pytest.raises(ValueError, match="transformer-family"):
        launch_serve.main(["--arch", ARCH, "--paged", "on", "--device",
                           "cpu", "--requests", "1"])


@pytest.mark.parametrize("arch", [ARCH, "zamba2-1.2b"])
def test_serve_launcher_serves_ssm_and_hybrid(arch, monkeypatch, capsys):
    monkeypatch.setattr(launch_serve, "get_config", smoke_config)
    assert launch_serve.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--policy", "sjf"]) == 0
    assert "completed=3" in capsys.readouterr().out
