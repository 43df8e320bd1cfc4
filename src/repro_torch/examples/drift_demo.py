"""Runtime token drift compensation, BIAS=OFF vs BIAS=ON — the paper's
core experiment (Fig 5, Fig 8, Table VII) on the full 3000-request
protocol.

    PYTHONPATH=src python -m repro_torch.examples.drift_demo [--policy sjf]
"""

import argparse

from repro_torch.core.drift import error_reduction
from repro_torch.core.estimator import DriftConfig
from repro_torch.core.scheduler import DriftScheduler
from repro_torch.serving.simulator import SimConfig, WorkerSimulator
from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator


def run(policy: str, bias: bool, seed: int = 1):
    plan = WorkloadGenerator(GeneratorConfig(seed=seed)).plan(seed=seed)
    sched = DriftScheduler(policy=policy,
                           config=DriftConfig(bias_enabled=bias))
    sim = WorkerSimulator(sched, plan, SimConfig(seed=seed))
    metrics = sim.run()
    return sched, sim, metrics


def sparkline(values, width=60):
    if not values:
        return ""
    blocks = " .:-=+*#%@"
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    idx = [int((v - lo) / span * (len(blocks) - 1)) for v in values]
    stride = max(len(idx) // width, 1)
    return "".join(blocks[i] for i in idx[::stride][:width])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="fifo")
    args = ap.parse_args()

    print(f"policy={args.policy}; 3000 requests "
          "(1000 calibration + 2000 stress)\n")
    s_off, _, m_off = run(args.policy, bias=False)
    s_on, sim, m_on = run(args.policy, bias=True)

    print("=== Fig 5: bias convergence (BIAS=ON) ===")
    hist = s_on.bias_store.history
    for cat in ("short_qa", "summary", "technical", "report"):
        vals = [h.bias for h in hist if h.category == cat]
        print(f"{cat:10s} 1.0 -> {vals[-1]:.3f}  [{sparkline(vals)}]")
    print(f"(paper band: 0.79-0.84; stress phase begins at "
          f"t={sim.phase_boundary:.0f}s)\n")

    off, on = s_off.drift.stats(), s_on.drift.stats()
    red = error_reduction(off, on)
    print("=== Table VII: estimation error ===")
    print(f"BIAS=OFF  MAE={off.mae:7.1f}  RMSE={off.rmse:7.1f}  "
          f"mean_error={off.mean_error:+7.1f}")
    print(f"BIAS=ON   MAE={on.mae:7.1f}  RMSE={on.rmse:7.1f}  "
          f"mean_error={on.mean_error:+7.1f}")
    print(f"reduction MAE {red['mae_reduction_pct']:.1f}% "
          f"(paper 38.8%)  RMSE {red['rmse_reduction_pct']:.1f}% "
          f"(paper 40.5%)\n")

    mis_off = s_off.drift.misclassification_rate(
        s_off.estimator.classify_budget)
    mis_on = s_on.drift.misclassification_rate(
        s_on.estimator.classify_budget)
    print("=== Fig 2: workload misclassification ===")
    print(f"BIAS=OFF {100*mis_off:.1f}%  ->  BIAS=ON {100*mis_on:.1f}%")

    print("\n=== e2e latency side effect ===")
    print(f"BIAS=OFF P50={m_off.e2e.p50:.1f}s  "
          f"BIAS=ON P50={m_on.e2e.p50:.1f}s")


if __name__ == "__main__":
    main()
