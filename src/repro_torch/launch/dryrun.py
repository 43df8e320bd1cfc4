"""One-card dry run: every (architecture x input shape) cell's step,
counted on the ``meta`` device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --out results/dryrun

Counterpart of the JAX package's ``launch/dryrun.py`` for one H100. For
each cell it builds the step (``make_train_step`` with AdamW,
``make_prefill_step`` or ``make_serve_step``) over ``abstract_params``
and the cell's ``input_specs``, runs it once on meta tensors under
``analysis.cost_analysis`` (no device, no allocation: any machine), and
writes ``<out>/<cell>.json`` with JAX's keys: ``status``, ``n_chips``
(1), ``cost_analysis``, ``memory_analysis`` (argument and output bytes;
meta cannot give the temporaries) and ``roofline`` (the H100's terms),
plus ``fits_one_card``: argument + output bytes within the card's HBM.
A cell outside ``shape_applicable`` is recorded as ``skipped`` with its
reason, one that raises as ``error`` (and the run exits 1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

from ..configs import ARCHS, SHAPES, Shape, get_config, input_specs, \
    shape_applicable
from ..distributed.optimizer import Optimizer, OptimizerConfig
from ..models.config import ModelConfig
from ..models.registry import abstract_params
from ..models.steps import make_prefill_step, make_serve_step, \
    make_train_step
from .analysis import cost_analysis, summarize_cell, tensor_bytes
from .mesh import HW

MESH = "1xH100"


def _cell_id(arch: str, shape: str) -> str:
    return f"{arch}__{shape}__{MESH}"


def count_cell(cfg: ModelConfig, shape: Shape) -> Dict:
    """The ``ok`` part of one cell's record: its step run once on meta
    tensors under the cost counter (``shape`` may be one of ``SHAPES``
    with its batch cut, as a run on the card cuts it)."""
    specs = input_specs(cfg, shape)
    params = abstract_params(cfg)
    if shape.kind == "train":
        opt = Optimizer(OptimizerConfig())
        step = make_train_step(cfg, opt)
        args = (params, opt.init(params), specs)
        n_tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, max_len=shape.seq_len)
        args = (params, specs, None)
        n_tokens = shape.global_batch * shape.seq_len
    else:
        step = make_serve_step(cfg)
        args = (params, specs["cache"], specs["tokens"], specs["pos"],
                specs["rng"])
        n_tokens = shape.global_batch     # one new token per sequence
    # the argument bytes before the step: a train step updates its
    # arguments in place
    mem = {"argument_size_in_bytes": tensor_bytes(args)}
    t0 = time.perf_counter()
    cost, out = cost_analysis(step, *args)
    run_s = time.perf_counter() - t0
    mem["output_size_in_bytes"] = tensor_bytes(out)
    io_bytes = float(mem["argument_size_in_bytes"]
                     + mem["output_size_in_bytes"])
    coll = {"total": 0}
    return {
        "status": "ok",
        "n_chips": 1,
        "run_s": round(run_s, 2),
        "cost_analysis": cost,
        "memory_analysis": mem,
        "fits_one_card": io_bytes <= HW["hbm_bytes"],
        "collective_bytes": coll,
        "roofline": summarize_cell(cfg, shape.kind, n_tokens, 1, cost, coll,
                                   io_bytes=io_bytes),
    }


def record_cell(cfg: ModelConfig, shape_name: str) -> Dict:
    """One cell's record (``ok``, ``skipped`` or ``error``)."""
    shape = SHAPES[shape_name]
    record: Dict = {"arch": cfg.name, "shape": shape_name, "mesh": MESH,
                    "kind": shape.kind}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        record.update({"status": "skipped", "reason": reason})
        return record
    try:
        record.update(count_cell(cfg, shape))
    except Exception as e:   # recorded per cell; main() exits 1 on any
        record.update({
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        })
    return record


def run_cell(arch: str, shape_name: str, *, out_dir: str,
             force: bool = False) -> Dict:
    """``record_cell`` of the published config of ``arch``, written to
    ``<out_dir>/<cell>.json`` (read back instead when it exists and not
    ``force``)."""
    path = os.path.join(out_dir, _cell_id(arch, shape_name) + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    record = record_cell(get_config(arch), shape_name)
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def status_line(rec: Dict) -> str:
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" bottleneck={r['bottleneck']}"
                 f" t>={r['step_time_lower_bound_s']:.4f}s"
                 f" fits_one_card={rec['fits_one_card']}")
    elif status == "error":
        extra = " " + rec["error"][:120]
    return f"[{status:7s}] {rec['arch']} x {rec['shape']} x {MESH}{extra}"


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCHS} or 'all' or comma list")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all' or comma list")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    failures = 0
    for arch in archs:
        for shape in shapes:
            rec = run_cell(arch, shape, out_dir=args.out, force=args.force)
            failures += rec["status"] == "error"
            print(status_line(rec), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
