#!/usr/bin/env python3
"""One run of one benchmark cell on the card:

    python3 driftbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Draws the weights and the traffic from the
seed, builds the port's scheduler and slot-ring engine, warms every
shape the traffic uses, runs the open-loop window, checks what the
engine produced against the plain reference, and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit. The same numbers are
the last lines on standard error; everything else goes there before
them.

Exits non-zero with no result line when there is no CUDA card (it
never falls back to the CPU), when the cell asks for more cards than
there are, or when the process has loaded JAX or the JAX package.
Kernel builds go to the port's build directory inside the checkout.
"""

import time

T_PROCESS = time.perf_counter()

import argparse      # noqa: E402
import gc            # noqa: E402
import json          # noqa: E402
import math          # noqa: E402
import subprocess    # noqa: E402
import sys           # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# compared by the whole top-level name: ``repro_torch`` is allowed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules) -> list:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _num(x: float):
    return x if math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from driftbench import bench, check, harness, trace

    man = bench.manifest()
    cell = bench.load_cell(args.workload, man=man)
    log = harness.log
    if not torch.cuda.is_available():
        log("no CUDA card: this benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    traced = bool(args.trace)
    metrics = bench.metrics_for(cell.name, traced, man)
    kind = torch.cuda.get_device_name(0)
    limit_w = power_limit()
    log(f"card {kind}, power limit {limit_w}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    torch.cuda.reset_peak_memory_stats()
    params = harness.draw_weights(cell, args.seed, "cuda")
    run = harness.run_window(cell, args.seed, args.seconds, traced, "cuda",
                             params, T_PROCESS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if traced:
        t = time.perf_counter()
        run.trace = trace.reduce(run.prof.events())
        log(f"trace: {run.trace['n_device_events']} device events read in "
            f"{time.perf_counter() - t:.1f} s")
    run.prof = None
    run.engine = None
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    ok, checks, details = check.verify(run, cell.reference,
                                       params, args.seed)
    log(f"check: {time.perf_counter() - t:.1f} s, "
        f"{ {k: v[:5] if isinstance(v, list) else v for k, v in details.items()} }")

    values = {}
    for m in metrics:
        v = bench.reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    steps = run.window_steps()
    log(f"window: {len(run.due_in_window())} due, {len(steps)} steps, "
        f"{run.tokens_in_window()} tokens, setup {run.setup_s:.3f} s")

    leaked = loaded_forbidden(sys.modules)
    if leaked:
        log(f"the process loaded {leaked}: the benchmark runs the port alone")
        return 3

    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(peak), "power_limit": limit_w}
    result = {"correct": ok, "attempted": len(run.due_in_window()),
              "failed": 0, "metrics": values, "device": device}
    if traced:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
        log(f"idle by host range: {run.trace['idle_by_range']}")
    bad = {rid for rid, _ in details["accounting"]}
    result["failed"] = sum(1 for r in run.due_in_window()
                           if r.req.req_id in bad)
    result["checks"] = {k: {"value": _num(float(v["value"])),
                            "limit": v["limit"]} for k, v in checks.items()}
    for k, v in checks.items():
        log(f"{k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
