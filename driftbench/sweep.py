#!/usr/bin/env python3
"""The knee sweep: the highest Poisson rate whose queue of undispatched
requests does not grow across a window, for one cell's configuration,
engine and content:

    python3 driftbench/sweep.py --workload <cell> --rates 6,8,10 \
        [--seconds 60] [--warm 30] [--seed 1] [--out FILE]

Each rate runs the cell's request content with Poisson arrivals at
that rate (and the warm-up given here, long enough for the slots to
fill) in one process on the card.
For each it reports the undispatched queue at the window's open and
close and its least-squares slope over the window (requests a second),
output tokens a second, and the mean of live lanes. The knee is the
highest rate whose slope is near zero and whose queue at the close is
near its open. The rates found go, as numbers, into the cells' files.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def queue_at(run, t: float) -> int:
    """Requests due by ``t`` and not yet dispatched at ``t``."""
    return sum(1 for r in run.reqs.values() if r.rec.due <= t
               and (r.req.dispatch_time is None or r.req.dispatch_time > t))


def live_at(run, t: float) -> int:
    """Requests dispatched by ``t`` and not yet completed at ``t``."""
    return sum(1 for r in run.reqs.values()
               if r.req.dispatch_time is not None and r.req.dispatch_time <= t
               and (r.req.completion_time is None
                    or r.req.completion_time > t))


def summarise(run, rate: float) -> dict:
    from driftbench.record import percentile
    ts = [run.t_open + run.window_s * k / 20 for k in range(21)]
    qs = [queue_at(run, t) for t in ts]
    mt, mq = sum(ts) / len(ts), sum(qs) / len(qs)
    slope = (sum((t - mt) * (q - mq) for t, q in zip(ts, qs))
             / sum((t - mt) ** 2 for t in ts))
    return {"rate_per_s": rate, "queue_open": qs[0], "queue_close": qs[-1],
            "queue_slope_per_s": slope,
            "output_tokens_per_s": run.tokens_in_window() / run.window_s,
            "live_lanes_mean": sum(live_at(run, t) for t in ts) / len(ts),
            "due": len(run.due_in_window()),
            "ttft_p95_ms": 1e3 * (percentile(run.ttfts(), 95) or 0.0),
            "itl_p95_ms": 1e3 * (percentile(run.token_gaps(), 95) or 0.0),
            "steps": len(run.window_steps())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--warm", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from driftbench import bench, harness
    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    cell = bench.load_cell(args.workload)
    params = harness.draw_weights(cell, args.seed, "cuda")
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        cell.spec = {**cell.spec, "rate_per_s": rate, "warm_s": args.warm}
        cell.traffic = {**cell.traffic, "arrivals": {"process": "poisson"}}
        run = harness.run_window(cell, args.seed, args.seconds, False,
                                 "cuda", params, time.perf_counter())
        run.engine = None
        row = summarise(run, rate)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del run
        gc.collect()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
