"""The port's serving engine and scheduler against the JAX package's.

* Lockstep engines: the port's and the JAX ``ServingEngine`` in float32
  on the same weights (bridged through numpy) serve the same seeded
  requests, stepped together. After every step each slot holds the same
  last token; at the end completion order, TTFT/completion stamps,
  chunk logs, launch counts and prefix-cache counters agree. Paged
  arms: chunk budget {None, 8} x prefix cache {off, on}. Slot-ring
  arms: chunk {None, 8} on smollm-135m; h2o-danube-1.8b (window 16)
  with buckets 16 and 32, which runs the ring roll and the saturating
  per-slot position (ROADMAP C); an int8-KV arm. The slot-ring arms
  also compare every slot's cache depth after every step.
* Paged vs slot-ring in the port: same completions and observed
  lengths, and the page allocator drains.
* Scheduler: the port's copy of ``DriftScheduler`` dispatches the same
  order and learns the same bias as ``repro.core``'s on one plan.
* Isolation: importing the port loads no ``jax`` and no ``repro``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.scheduler import DriftScheduler as JaxScheduler
from repro.models import transformer as jax_transformer
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServingEngine as JaxEngine
from repro.workload.generator import GeneratorConfig as JaxGeneratorConfig
from repro.workload.generator import WorkloadGenerator as JaxGenerator
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.core.scheduler import DriftScheduler
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator

ROOT = Path(__file__).resolve().parents[1]
CFG_J = jax_smoke_config("smollm-135m").replace(dtype="float32")
CFG_T = smoke_config("smollm-135m").replace(dtype="float32")
PARAMS_J = jax_transformer.init(CFG_J, jax.random.PRNGKey(0))
PARAMS_T = params_from_numpy(
    CFG_T, jax.tree_util.tree_map(np.asarray, PARAMS_J), device="cpu")
DANUBE_J = jax_smoke_config("h2o-danube-1.8b").replace(dtype="float32")
DANUBE_T = smoke_config("h2o-danube-1.8b").replace(dtype="float32")
DANUBE_PARAMS_J = jax_transformer.init(DANUBE_J, jax.random.PRNGKey(0))
DANUBE_PARAMS_T = params_from_numpy(
    DANUBE_T, jax.tree_util.tree_map(np.asarray, DANUBE_PARAMS_J),
    device="cpu")


def _plans(n, seed, **kw):
    """The same plan from both packages' generators (checked equal)."""
    gk = dict(total_requests=n, calibration_requests=n, seed=seed, **kw)
    jr = [r for _, r in JaxGenerator(JaxGeneratorConfig(**gk))
          .plan(seed=seed).calibration]
    tr = [r for _, r in WorkloadGenerator(GeneratorConfig(**gk))
          .plan(seed=seed).calibration]
    for a, b in zip(jr, tr):
        assert (a.prompt, a.prompt_tokens, a.true_output_tokens,
                a.tenant.label, a.category.value, a.prefix_group) == \
               (b.prompt, b.prompt_tokens, b.true_output_tokens,
                b.tenant.label, b.category.value, b.prefix_group)
    return jr, tr


def _record(reqs, sched):
    idx = {r.req_id: i for i, r in enumerate(reqs)}
    return [(idx[r.req_id], r.observed_output_tokens, r.cached_prompt_tokens,
             r.prefill_end, r.exec_end) for r in sched.completed]


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("prefix", [False, True])
def test_engines_emit_the_same_tokens_in_lockstep(chunk, prefix):
    kw = dict(n_slots=3, max_len=96, prompt_buckets=(32, 64), paged=True,
              page_size=8, chunk_prefill_tokens=chunk, prefix_cache=prefix,
              prefix_cache_pages=16)
    js, ts = JaxScheduler("fifo"), DriftScheduler("fifo")
    je = JaxEngine(CFG_J, PARAMS_J, js, JaxEngineConfig(**kw))
    te = ServingEngine(CFG_T, PARAMS_T, ts, EngineConfig(**kw), device="cpu")
    jr, tr = _plans(8, seed=3, max_tokens=12,
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
        assert te.active_slots() == je.active_slots()
        now += 1.0
    assert not ts.queue_depth() and not te.active_slots()
    assert len(ts.completed) == len(tr)
    assert _record(tr, ts) == _record(jr, js)
    assert te.prefill_chunk_log == je.prefill_chunk_log
    assert te.n_prefill_launches == je.n_prefill_launches
    assert te.step_count == je.step_count
    assert te.prefix_cache_stats() == je.prefix_cache_stats()
    if prefix:
        assert te.prefix_cache_stats()["hits"] > 0
    assert te.alloc.free_pages + te.ledger.owned_pages() + (
        te.prefix_tree.total_pages() if prefix else 0) == te.alloc.n_pages


@pytest.mark.parametrize("arch,chunk,buckets,kv", [
    ("smollm-135m", None, (32, 64), "bfloat16"),
    ("smollm-135m", 8, (32, 64), "bfloat16"),
    ("h2o-danube-1.8b", None, (16, 32), "bfloat16"),  # roll + saturation
    ("smollm-135m", 8, (16, 32), "int8"),
])
def test_slot_ring_engines_emit_the_same_tokens_in_lockstep(arch, chunk,
                                                            buckets, kv):
    cfg_j, cfg_t, pj, pt = ((CFG_J, CFG_T, PARAMS_J, PARAMS_T)
                            if arch == "smollm-135m" else
                            (DANUBE_J, DANUBE_T, DANUBE_PARAMS_J,
                             DANUBE_PARAMS_T))
    cfg_j, cfg_t = cfg_j.replace(kv_dtype=kv), cfg_t.replace(kv_dtype=kv)
    kw = dict(n_slots=3, max_len=96, prompt_buckets=buckets,
              chunk_prefill_tokens=chunk)
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
    assert te.n_prefill_launches == je.n_prefill_launches == 0
    assert te.cache["k"].dtype == (torch.int8 if kv == "int8"
                                   else torch.float32)
    if arch == "h2o-danube-1.8b":
        # the ring is window-sized; a full ring's depth saturates at S
        assert te.cache["k"].shape[2] == 16
        assert max(te.cache["lens"].tolist()) == 16


def test_paged_engine_matches_slot_ring_completions():
    """The port's paged and slot-ring engines: same scheduler behaviour,
    same observed lengths, and the allocator fully drains."""

    def run(paged):
        sched = DriftScheduler("fifo")
        eng = ServingEngine(CFG_T, PARAMS_T, sched,
                            EngineConfig(n_slots=3, max_len=96,
                                         prompt_buckets=(16,), paged=paged,
                                         page_size=8), device="cpu")
        _, reqs = _plans(8, seed=3, max_tokens=24)
        for i, r in enumerate(reqs):
            sched.submit(r, 1e-6 * i)
        return eng, sched, eng.run_until_drained(max_steps=5000)

    eng_p, sched_p, m_p = run(paged=True)
    eng_c, sched_c, m_c = run(paged=False)
    assert m_p.n_completed == m_c.n_completed == 8
    assert sorted(r.observed_output_tokens for r in sched_p.completed) == \
        sorted(r.observed_output_tokens for r in sched_c.completed)
    assert eng_p.alloc.free_pages == eng_p.alloc.n_pages


def test_schedulers_dispatch_the_same_order_and_learn_the_same_bias():
    jr, tr = _plans(40, seed=5, max_tokens=256)
    out = []
    for sched, reqs in ((JaxScheduler("sjf"), jr), (DriftScheduler("sjf"), tr)):
        for i, r in enumerate(reqs):
            sched.submit(r, 0.01 * i)
        idx = {r.req_id: i for i, r in enumerate(reqs)}
        order, now = [], 1.0
        while sched.queue_depth():
            req = sched.dispatch(now)
            order.append(idx[req.req_id])
            sched.complete(req, min(req.true_output_tokens, req.max_tokens),
                           now + 0.5)
            now += 1.0
        out.append((order, sched.bias_store.snapshot()))
    assert out[0] == out[1]


def test_tokenize_full_vocab_legacy_layout():
    """Prompt bytes right-aligned as ``byte + 1`` at a vocab above 255
    (the JAX engine's uint8 form overflows there under numpy 2)."""
    cfg = smoke_config("smollm-135m").replace(vocab=49152)
    eng = ServingEngine(cfg, PARAMS_T, DriftScheduler("fifo"),
                        EngineConfig(paged=True), device="cpu")
    _, (req, *_) = _plans(1, seed=3)
    n = min(req.prompt_tokens, 16)
    toks = eng._tokenize(req, 32, n, 0)
    raw = np.frombuffer(req.prompt.encode(), np.uint8)[:n].astype(np.int64)
    assert toks.shape == (1, 32) and not toks[0, :32 - n].any()
    np.testing.assert_array_equal(toks[0, 32 - n:], raw + 1)


def test_engine_refuses_what_later_slices_port():
    sched = DriftScheduler("fifo")
    with pytest.raises(NotImplementedError, match="later slice"):
        ServingEngine(CFG_T.replace(family="ssm"), PARAMS_T, sched,
                      EngineConfig(paged=False), device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        ServingEngine(CFG_T.replace(family="vlm"), PARAMS_T, sched,
                      EngineConfig(paged=True), device="cpu")


def test_cuda_requested_without_cuda_raises(monkeypatch):
    """No entry point moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(CFG_T, PARAMS_T, DriftScheduler("fifo"),
                      EngineConfig(paged=True), device="cuda")


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serving.engine\n"
        "import repro_torch.launch.serve, repro_torch.bridge\n"
        "import repro_torch.kernels.ops, repro_torch.configs\n"
        "import repro_torch.launch.train, repro_torch.models.mamba2\n"
        "import repro_torch.distributed.optimizer, repro_torch.data.pipeline\n"
        "import repro_torch.distributed.checkpoint, repro_torch.models.steps\n"
        "import repro_torch.cluster, repro_torch.cluster.driver\n"
        "import repro_torch.serving.simulator, repro_torch.serving.vector_sim\n"
        "import repro_torch.obs.report, repro_torch.distributed.fault_tolerance\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_port_sources_never_import_jax_or_repro():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|import\s+repro\."
        r"|from\s+repro\b|from\s+repro\.)", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").parts[0]
               for p in files if "repro_torch" in p.parts}
    assert {"distributed", "data", "launch", "models", "kernels", "cluster",
            "obs", "serving", "core", "workload"} <= scanned
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, (path, hits)
