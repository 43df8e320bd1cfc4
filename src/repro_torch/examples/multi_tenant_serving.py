"""End-to-end example: the port's continuous-batching engine serving
batched multi-tenant requests under DriftSched, on the card.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving \
        [--arch smollm-135m] [--policy sjf] [--requests 32] \
        [--preset full|smoke] [--device cuda|cpu] [--seed 0]

The JAX example's state machine on the port's slot-ring
``ServingEngine``: every active slot decodes one token per iteration,
admissions come from the DriftScheduler queues and prefill in one shot
(one flash-attention launch per attention layer), slots retire at the
oracle end of sequence, and the observed lengths feed the drift
compensator. ``--preset full`` (the default) serves the arch's
published widths, ``smoke`` its reduced config (the JAX example's
model); weights are random, drawn from ``--seed`` on the run's device.
Because slots retire at the oracle end of sequence, the step counts,
latencies, learned bias and observed tokens do not depend on the
weights: ``--preset smoke --device cpu`` prints the JAX example's lines
but for the wall-clock figure.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.estimator import DriftConfig
from repro_torch.core.scheduler import DriftScheduler
from repro_torch.models.layers import resolve_device
from repro_torch.models.registry import get_api
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator


def main(argv: Optional[list] = None):
    """Serve, print the report; returns the drained engine and the wall
    seconds of the drain (for a caller that measures them)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCHS)
    ap.add_argument("--policy", default="sjf")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--preset", default="full", choices=["smoke", "full"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.preset == "smoke" \
        else get_config(args.arch)
    api = get_api(cfg)
    print(f"model={cfg.name} ({cfg.param_count()/1e6:.2f}M params, "
          f"family={cfg.family}) slots={args.slots} policy={args.policy}")
    params = api.init(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)

    sched = DriftScheduler(policy=args.policy, config=DriftConfig())
    engine = ServingEngine(cfg, params, sched,
                           EngineConfig(n_slots=args.slots, max_len=128,
                                        prompt_buckets=(16, 32)),
                           device=device)

    gen = WorkloadGenerator(GeneratorConfig(
        total_requests=args.requests,
        calibration_requests=args.requests,
        max_tokens=64, seed=0))
    for t, r in gen.plan(seed=0).calibration:
        sched.submit(r, t)
    print(f"submitted {args.requests} requests across 3 tenants")

    t0 = time.time()
    metrics = engine.run_until_drained()
    wall = time.time() - t0
    where = "CPU" if device.type == "cpu" else torch.cuda.get_device_name(device)
    print(f"\ndrained in {engine.step_count} engine steps "
          f"({wall:.1f}s wall on {where})")
    print(f"completed={metrics.n_completed} "
          f"throughput={metrics.n_completed/engine.step_count:.2f} "
          "req/engine-step")
    for t, v in metrics.per_tenant.items():
        print(f"tenant {t:9s} mean latency={v['latency']['mean']:7.1f} "
              f"steps, wait={v['queue_wait']['mean']:7.1f}")
    print("learned bias:",
          {k: round(v, 3) for k, v in sched.bias_store.snapshot().items()})
    obs = [r.observed_output_tokens for r in sched.completed]
    print(f"observed output tokens: min={min(obs)} max={max(obs)} "
          f"mean={sum(obs)/len(obs):.1f}")
    return engine, wall


if __name__ == "__main__":
    main()
