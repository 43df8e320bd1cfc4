"""Per-device roofline terms of every cell on the 16 x 16 mesh.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --arch all --shape all --out results/roofline

Port of the JAX package's ``launch/roofline.py``, same ``_KEYS``, probe
plan and record layout. JAX needs structural depth probes because
XLA's cost analysis counts a while-loop body once. The port's layer
loops are Python loops, so ``dryrun.lower_cell`` counts the full depth
directly, and that count is the record's roofline. The probes are kept
as a check: each family's structural model is solved from the probes
exactly as JAX solves it,

    dense / moe / vlm / ssm:  f(k) = fixed + k * layer,  k in {1, 2}
    encdec:                   f(d, e) = fixed + d * dec + e * enc
    hybrid (attn_every=A):    f(k) = fixed + k * mamba + ceil(k/A) * shared

and extrapolated to full depth; ``probe_check_max_rel`` is the largest
relative difference of the extrapolation from the direct count over
``_KEYS``: 0 where every layer adds the same work, as the FLOPs do on
every cell; a train step's bytes and collectives can miss the line the
shallow probes draw, which is why the record keeps the direct count. Every
quantity is per device on the 16 x 16 mesh of the fake process group
(``dryrun.production_mesh``). The port counts no transcendentals: that
key is 0.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..models.config import ModelConfig
from . import dryrun as dr
from .analysis import summarize_cell

# quantities extrapolated through the structural model
_KEYS = ("flops", "bytes", "transcendentals", "io_bytes",
         "coll_all-reduce", "coll_all-gather", "coll_reduce-scatter",
         "coll_all-to-all", "coll_collective-permute", "coll_total",
         "ops_all-reduce", "ops_all-gather", "ops_reduce-scatter",
         "ops_all-to-all", "ops_collective-permute")


def _measure(cfg: ModelConfig, shape_name: str, mesh,
             **knobs) -> Dict[str, float]:
    """One count of a cell's step and its raw per-device quantities."""
    got = dr.lower_cell(cfg, shape_name, mesh, **knobs)
    mem = got["memory_analysis"]
    out = {"flops": got["cost_analysis"]["flops"],
           "bytes": got["cost_analysis"]["bytes accessed"],
           "transcendentals": 0.0,
           "io_bytes": float(mem["argument_size_in_bytes"]
                             + mem["output_size_in_bytes"])}
    for k, v in got["collective_bytes"].items():
        out[f"coll_{k}"] = float(v)
    for k, v in got["collective_ops"].items():
        out[f"ops_{k}"] = float(v)
    return out


def _combine(points: List[Tuple[Dict[str, float], Dict[str, float]]],
             full_counts: Dict[str, float]) -> Dict[str, float]:
    """Solve  f(probe) = fixed + sum_c counts[c] * unit_c  exactly.

    ``points`` = [(counts, measured)], with len(points) = n_units + 1.
    ``full_counts`` = structural counts at full depth.
    """
    units = sorted({c for counts, _ in points for c in counts})
    A = np.array([[1.0] + [counts.get(u, 0.0) for u in units]
                  for counts, _ in points])
    out = {}
    for key in _KEYS:
        b = np.array([m.get(key, 0.0) for _, m in points])
        try:
            coef, *_ = np.linalg.lstsq(A, b, rcond=None)
        except np.linalg.LinAlgError:
            out[key] = float(b[-1])
            continue
        val = coef[0] + sum(coef[1 + i] * full_counts.get(u, 0.0)
                            for i, u in enumerate(units))
        out[key] = float(max(val, 0.0))
    return out


def _probe_plan(cfg: ModelConfig):
    """[(probe_cfg, counts)], full_counts."""
    if cfg.family == "encdec":
        pts = [(cfg.replace(n_layers=d, n_enc_layers=e),
                {"dec": d, "enc": e})
               for d, e in ((1, 1), (2, 1), (1, 2))]
        return pts, {"dec": cfg.n_layers, "enc": cfg.n_enc_layers}
    if cfg.family == "hybrid":
        A = cfg.attn_every

        def counts(k):
            return {"mamba": k, "shared": math.ceil(k / A)}
        ks = (1, 2, A + 1)
        pts = [(cfg.replace(n_layers=k), counts(k)) for k in ks]
        return pts, counts(cfg.n_layers)
    pts = [(cfg.replace(n_layers=k), {"layer": k}) for k in (1, 2)]
    return pts, {"layer": cfg.n_layers}


def probe_check(extrap: Dict[str, float], full: Dict[str, float]) -> float:
    """The largest relative difference over ``_KEYS`` of the probes'
    extrapolation from the direct full-depth count."""
    worst = 0.0
    for key in _KEYS:
        a, b = extrap.get(key, 0.0), full.get(key, 0.0)
        worst = max(worst, abs(a - b) / max(abs(b), 1.0))
    return worst


def record_cell(cfg: ModelConfig, shape_name: str, *, variant: str = "",
                **knobs) -> Dict:
    """One cell's roofline record on 16 x 16 (``ok``, ``skipped`` or
    ``error``)."""
    shape = SHAPES[shape_name]
    record: Dict = {"arch": cfg.name, "shape": shape_name, "mesh": "16x16",
                    "kind": shape.kind, "variant": variant}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        record.update({"status": "skipped", "reason": reason})
        return record
    try:
        mesh = dr.production_mesh(False)
        t0 = time.time()
        plan, full_counts = _probe_plan(cfg)
        points = [(counts, _measure(pcfg, shape_name, mesh, **knobs))
                  for pcfg, counts in plan]
        extrap = _combine(points, full_counts)
        full = _measure(cfg, shape_name, mesh, **knobs)
        coll = {k.replace("coll_", ""): v for k, v in full.items()
                if k.startswith("coll_")}
        summary = summarize_cell(
            cfg, shape.kind,
            shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                  else 1),
            mesh.size(),
            {"flops": full["flops"], "bytes accessed": full["bytes"]},
            coll, io_bytes=full["io_bytes"])
        record.update({
            "status": "ok",
            "n_chips": mesh.size(),
            "probe_s": round(time.time() - t0, 1),
            "probes": [{"counts": c, **m} for c, m in points],
            "extrapolated": extrap,
            "full": full,
            "probe_check_max_rel": probe_check(extrap, full),
            "roofline": summary,
        })
    except Exception as e:
        record.update({"status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]})
    return record


def run_cell(arch: str, shape_name: str, *, out_dir: str,
             force: bool = False, variant: str = "", **knobs) -> Dict:
    """``record_cell`` of ``arch``'s published config, written to
    ``<out_dir>/<arch>__<shape>.json`` (read back instead when it exists
    and not ``force``)."""
    cfg = get_config(arch)
    cell = f"{arch}__{shape_name}" + (f"__{variant}" if variant else "")
    path = os.path.join(out_dir, cell + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    record = record_cell(cfg, shape_name, variant=variant, **knobs)
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="results/roofline")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    failures = 0
    for arch in archs:
        for shape in shapes:
            rec = run_cell(arch, shape, out_dir=args.out, force=args.force)
            status = rec["status"]
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (f" {r['bottleneck']}-bound"
                         f" t>={r['step_time_lower_bound_s']:.4f}s"
                         f" frac={r['roofline_fraction']:.2f}"
                         f" probe_check={rec['probe_check_max_rel']:.1e}")
            elif status == "error":
                failures += 1
                extra = " " + rec["error"][:120]
            print(f"[{status:7s}] roofline {arch} x {shape}{extra}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
