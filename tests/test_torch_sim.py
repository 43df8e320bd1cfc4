"""The port's copies of the simulators against the JAX package's.

* ``WorkerSimulator`` through ``make_worker_simulator`` on the object
  and the vector backends: the same plan (each package's generator at
  one seed, checked equal request by request) under the same scheduler
  settings gives equal ``RunMetrics.as_dict()``.
* ``ClusterSimulator`` under ``pd_disaggregated`` routing with a replica
  failure gives equal cluster metrics and P/D counters.
* ``repro_torch.launch.serve --engine sim --json`` prints what
  ``repro.launch.serve --engine sim --json`` prints.

All of it is host code with no randomness outside the seeded plans, so
the comparisons are exact (NaN equal to NaN).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.cluster.simulator import ClusterConfig as JaxClusterConfig
from repro.cluster.simulator import ClusterSimulator as JaxClusterSimulator
from repro.core.scheduler import DriftScheduler as JaxScheduler
from repro.serving.simulator import SimConfig as JaxSimConfig
from repro.serving.simulator import make_worker_simulator as jax_make_sim
from repro.workload.generator import GeneratorConfig as JaxGeneratorConfig
from repro.workload.generator import WorkloadGenerator as JaxGenerator
from repro_torch.cluster.simulator import ClusterConfig, ClusterSimulator
from repro_torch.core.scheduler import DriftScheduler
from repro_torch.serving.simulator import SimConfig, make_worker_simulator
from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator

ROOT = Path(__file__).resolve().parents[1]


def _eq(a, b):
    """Exact equality, except NaN == NaN."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) \
            and np.isnan(a) and np.isnan(b):
        return True
    return a == b


def _plans(seed, **kw):
    """The same arrival plan from both packages' generators."""
    jp = JaxGenerator(JaxGeneratorConfig(seed=seed, **kw)).plan(seed=seed)
    tp = WorkloadGenerator(GeneratorConfig(seed=seed, **kw)).plan(seed=seed)
    for phase in ("calibration", "stress"):
        ja, ta = getattr(jp, phase), getattr(tp, phase)
        assert len(ja) == len(ta)
        for (t1, a), (t2, b) in zip(ja, ta):
            assert (t1, a.prompt, a.prompt_tokens, a.true_output_tokens,
                    a.tenant.label, a.category.value, a.prefix_group) == \
                   (t2, b.prompt, b.prompt_tokens, b.true_output_tokens,
                    b.tenant.label, b.category.value, b.prefix_group)
    return jp, tp


ARMS = {
    "chunked": dict(step_engine=True, continuous_joins=True,
                    chunk_prefill_tokens=256, batch_capacity=8),
    "prefix_failure": dict(step_engine=True, continuous_joins=True,
                           prefix_cache=True, n_workers=2,
                           fail_times=(10.0,)),
}


@pytest.mark.parametrize("backend", ["object", "vector"])
@pytest.mark.parametrize("policy", ["fifo", "sjf"])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_worker_simulator_metrics_match_jax(arm, policy, backend):
    jp, tp = _plans(7, total_requests=120, calibration_requests=30,
                    shared_prefix_tokens=192, prefix_groups_per_tenant=2)
    kw = dict(seed=7, backend=backend, **ARMS[arm])
    js, ts = JaxScheduler(policy), DriftScheduler(policy)
    mj = jax_make_sim(js, jp, JaxSimConfig(**kw)).run()
    mt = make_worker_simulator(ts, tp, SimConfig(**kw)).run()
    assert mt.n_completed == mj.n_completed > 0
    assert _eq(mt.as_dict(), mj.as_dict())
    assert ts.bias_store.snapshot() == js.bias_store.snapshot()
    if ARMS[arm].get("fail_times"):    # the failure hit running work
        assert mt.n_failed_dispatches > 0


@pytest.mark.parametrize("n_prefill,fail,kv_base", [
    (2, (3.0, 0), 0.5),      # a prefill replica dies: transfers lost
    (1, (5.0, 2), 0.002),    # a decode replica dies: work re-prefills
], ids=["prefill_fails", "decode_fails"])
def test_cluster_simulator_pd_with_failure_matches_jax(n_prefill, fail,
                                                       kv_base):
    jp, tp = _plans(3, total_requests=160, calibration_requests=40)
    kw = dict(n_replicas=4, routing="pd_disaggregated",
              n_prefill_replicas=n_prefill, scheduler_policy="sjf",
              step_engine=True, continuous_joins=True,
              chunk_prefill_tokens=256, work_stealing=True,
              fail_events=(fail,), kv_transfer_base=kv_base, seed=3)
    js = JaxClusterSimulator(jp, JaxClusterConfig(**kw))
    ts = ClusterSimulator(tp, ClusterConfig(**kw))
    mj, mt = js.run(), ts.run()
    assert mt.run.n_completed == mj.run.n_completed == 160
    assert _eq(mt.as_dict(), mj.as_dict())
    assert (ts.n_handoffs, ts.n_handoffs_lost) == \
        (js.n_handoffs, js.n_handoffs_lost)
    # the failure reached work in flight
    assert ts.n_handoffs_lost + mt.n_rerouted > 0


def _serve_json(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", module, "--engine", "sim", "--json", *args],
        env=env, text=True, capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


@pytest.mark.parametrize("args", [
    ("--requests", "90"),
    ("--requests", "90", "--policy", "sjf", "--bias", "off",
     "--workers", "2", "--fail-at", "20"),
])
def test_serve_sim_prints_the_jax_launchers_json(args):
    got = _serve_json("repro_torch.launch.serve", *args)
    want = _serve_json("repro.launch.serve", *args)
    assert got == want
    assert json.loads(got)["e2e"]["n"] > 0
