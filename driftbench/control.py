#!/usr/bin/env python3
"""The readings that the ``logit_gap`` limit is set from, on the card:

    python3 driftbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 10] [--out FILE]

For each seed, in one process: draw the weights, run the cell's window
at its own load (``--seconds`` long, enough to finish the mix's long
requests and to sample as many as a benchmark run does), and read the
program's widest gap over the sampled requests, as ``run.py`` does.
For the control seeds, also the control's: the fp8 reference at each
position of the same prompts and served tokens (``check.gaps``). One
JSON line a seed on standard output, and all of them in ``--out``.
The benchmark's runs never run this.
"""

import time

T_PROCESS = time.perf_counter()

import argparse      # noqa: E402
import gc            # noqa: E402
import json          # noqa: E402
import sys           # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from driftbench import bench, check, harness
    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    cell = bench.load_cell(args.workload)
    fam = cell.reference
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        params = harness.draw_weights(cell, seed, "cuda")
        run = harness.run_window(cell, seed, args.seconds, False, "cuda",
                                 params, time.perf_counter())
        run.engine = None
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        picked = check.sample(run, check.SAMPLE, seed)
        per = check.gaps(run, fam, params, picked, control=seed in controls)
        if not per:
            harness.log(f"seed {seed}: no request finished in the window")
            continue
        row = {"workload": cell.name, "seed": seed,
               "program_gap": max(g for g, _ in per),
               "control_gap": (max(c for _, c in per) if seed in controls
                               else None),
               "program_gaps": [g for g, _ in per],
               "control_gaps": [c for _, c in per] if seed in controls
               else None,
               "tokens": [len(r.tokens) for r in picked],
               "accounting": len(check.accounting(run)),
               "scheduler": len(check.scheduler(run)),
               "check_s": time.perf_counter() - t,
               "setup_s": run.setup_s}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del run, params, per
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
