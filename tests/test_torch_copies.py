"""Every host-only file the port copies from the JAX package is still a
byte copy of its original.

The port never imports ``repro``; the layers it shares with it
(scheduler, workload, observability, simulators, cluster front end) are
copies under the same relative path. This test keeps a copy from
drifting silently. ``serving/engine.py``, ``serving/kv_cache.py``,
``cluster/driver.py`` and ``obs/events.py`` (the JAX events and ring,
plus the port's host-clock spans) are ports, not copies, and are not
listed.
"""

from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

COPIES = [
    "core/__init__.py", "core/admission.py", "core/drift.py",
    "core/estimator.py", "core/policies.py", "core/queues.py",
    "core/request.py", "core/scheduler.py",
    "obs/__init__.py", "obs/stats.py", "obs/series.py",
    "obs/slo.py", "obs/timeline.py", "obs/report.py",
    "workload/__init__.py", "workload/corpus.py", "workload/generator.py",
    "serving/metrics.py", "serving/cost_model.py", "serving/simulator.py",
    "serving/vector_sim.py",
    "models/config.py", "data/pipeline.py",
    "configs/smollm_135m.py", "configs/h2o_danube_1_8b.py",
    "configs/mamba2_2_7b.py", "configs/minitron_4b.py",
    "configs/minitron_8b.py", "configs/zamba2_1_2b.py",
    "configs/whisper_large_v3.py", "configs/paligemma_3b.py",
    "configs/grok_1_314b.py", "configs/llama4_scout_17b_a16e.py",
    "distributed/fault_tolerance.py",
    "cluster/__init__.py", "cluster/replica.py", "cluster/admission.py",
    "cluster/router.py", "cluster/autoscaler.py", "cluster/metrics.py",
    "cluster/simulator.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_equal_to_its_jax_original(rel):
    port, jax_file = SRC / "repro_torch" / rel, SRC / "repro" / rel
    assert port.read_bytes() == jax_file.read_bytes(), rel


def test_arch_registry_lists_the_jax_catalog():
    """The port's ``--arch`` choices are the JAX package's ten archs, in
    its order."""
    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import ARCHS
    assert ARCHS == JAX_ARCHS and len(ARCHS) == 10
