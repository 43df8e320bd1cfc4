"""Serving launcher of the port: the serving engine on one device, or
the discrete-event simulator.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch smollm-135m --requests 24 [--paged on]
    PYTHONPATH=src python -m repro_torch.launch.serve --engine sim \
        --policy sjf --bias on

``--engine torch`` (the default) is the counterpart of the JAX package's
``launch/serve.py --engine jax``: the real continuous-batching engine,
here at the arch's full width on ``cuda`` (random weights from
``--seed``), with the same scheduler state machine. ``--paged off`` (the
default) is that launcher's engine, the slot-ring cache; ``--paged on``
serves from the paged KV pool. ``--device cpu`` runs on the CPU with the
kernels' plain versions.

``--engine sim`` runs the discrete-event simulator with the
L4-calibrated cost model, the configuration every paper table uses, on
the host only; it prints what the JAX launcher's ``--engine sim`` prints
for the same arguments.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..configs import ARCHS, get_config
from ..core.estimator import DriftConfig
from ..core.scheduler import DriftScheduler
from ..models.registry import get_api
from ..serving.engine import EngineConfig, ServingEngine
from ..serving.simulator import SimConfig, WorkerSimulator
from ..workload.generator import GeneratorConfig, WorkloadGenerator


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engine", default="torch", choices=["torch", "sim"])
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "priority", "weighted", "sjf", "aging"])
    ap.add_argument("--bias", default="on", choices=["on", "off"])
    ap.add_argument("--requests", type=int, default=None,
                    help="default: 24 (torch), 3000 (sim, the paper's "
                         "protocol)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--arch", default="smollm-135m", choices=ARCHS)
    ap.add_argument("--paged", default="off", choices=["on", "off"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=1,
                    help="simulated workers (sim)")
    ap.add_argument("--fail-at", type=float, default=None,
                    help="inject a worker failure at this time (s) (sim)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.requests is None:
        args.requests = 3000 if args.engine == "sim" else 24

    sched = DriftScheduler(
        policy=args.policy,
        config=DriftConfig(bias_enabled=args.bias == "on"))

    if args.engine == "sim":
        gen = WorkloadGenerator(GeneratorConfig(
            total_requests=args.requests,
            calibration_requests=args.requests // 3,
            seed=args.seed))
        plan = gen.plan(seed=args.seed)
        sim_cfg = SimConfig(
            seed=args.seed, n_workers=args.workers,
            fail_times=(args.fail_at,) if args.fail_at else ())
        metrics = WorkerSimulator(sched, plan, sim_cfg).run()
    else:
        cfg = get_config(args.arch)
        params = get_api(cfg).init(
            cfg, torch.Generator().manual_seed(args.seed), device=args.device)
        eng = ServingEngine(cfg, params, sched,
                            EngineConfig(n_slots=8, max_len=128,
                                         prompt_buckets=(16, 32),
                                         paged=args.paged == "on"),
                            device=args.device)
        gen = WorkloadGenerator(GeneratorConfig(
            total_requests=args.requests,
            calibration_requests=args.requests,
            max_tokens=64, seed=args.seed))
        for t, r in gen.plan(seed=args.seed).calibration:
            sched.submit(r, t)
        metrics = eng.run_until_drained()

    out = metrics.as_dict()
    out["learned_bias"] = sched.bias_store.snapshot()
    if args.json:
        print(json.dumps(out, indent=1, default=float))
    else:
        print(f"policy={args.policy} bias={args.bias} "
              f"completed={metrics.n_completed}")
        print(f"e2e    P50={metrics.e2e.p50:8.2f}s "
              f"P95={metrics.e2e.p95:8.2f}s P99={metrics.e2e.p99:8.2f}s")
        print(f"wait   mean={metrics.queue_wait.mean:7.2f}s")
        print(f"exec   P50={metrics.gpu_exec.p50:8.2f}s "
              f"util={metrics.gpu_utilization:.0%}")
        for t, v in metrics.per_tenant.items():
            print(f"tenant {t:9s} latency={v['latency']['mean']:7.1f}s "
                  f"wait={v['queue_wait']['mean']:7.1f}s")
        print("learned bias:", {k: round(v, 3)
                                for k, v in out["learned_bias"].items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
