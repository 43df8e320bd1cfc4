"""Dry run: every (architecture x input shape) cell's step, counted on
the ``meta`` device, on one card or on the production meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --out results/dryrun            # one card
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh both --out results/dryrun

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

``--mesh single|multi|both`` is the mesh half (JAX's ``--mesh``): the
16 x 16 (``data``, ``model``) and 2 x 16 x 16 (``pod``, ``data``,
``model``) meshes of ``mesh.make_production_mesh`` on the fake process
group of 256 or 512 ranks (``mesh.open_fake_group``: this process is
rank 0 and no collective moves a byte). :func:`lower_cell` places the
cell's abstract trees by its shardings (``launch/sharded.py``: meta
DTensors) and runs the step once under ``analysis.MeshCounter``, so
FLOPs, bytes and ``memory_analysis`` are one device's, of its local
shards, and every collective DTensor issues is recorded. The records
keep JAX's keys: ``n_chips`` 256 or 512, ``param_policy``,
``collective_bytes`` and ``collective_ops`` by kind, ``roofline`` and
``mesh`` ``"16x16"`` or ``"2x16x16"``, in ``<out>/<arch>__<shape>__pod``
(``__multipod``) ``.json``. ``--mesh card``, the default, is the
one-card run above.
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
from . import sharded
from .analysis import cost_analysis, count_collective_ops, \
    local_tensor_bytes, mesh_cost_analysis, parse_collective_bytes, \
    summarize_cell, tensor_bytes
from .mesh import HW, PRODUCTION_SHAPES, make_production_mesh, \
    open_fake_group

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


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, PRODUCTION_SHAPES[multi_pod][0]))


def production_mesh(multi_pod: bool):
    """The 16 x 16 or 2 x 16 x 16 mesh on a fake process group of its
    size (the group of another size is closed first)."""
    shape, _ = PRODUCTION_SHAPES[multi_pod]
    n = 1
    for d in shape:
        n *= d
    open_fake_group(n)
    return make_production_mesh(multi_pod=multi_pod)


def lower_cell(cfg: ModelConfig, shape: "str | Shape", mesh, *,
               remat: bool = True, param_mode: Optional[str] = None,
               batch_mode: str = "default",
               rules_mode: Optional[str] = None) -> Dict:
    """One cell's step on ``mesh``, counted once on meta DTensors: the
    ``ok`` part of its record without the roofline, plus ``kind`` and
    ``n_tokens``. Knobs as JAX's ``lower_cell``: ``param_mode`` train |
    serve | replicated | serve-2d (``cell_shardings.params_shardings_for``;
    default train for a train cell, serve otherwise), ``batch_mode``
    default | dp-all (batch over the model axis too; the activation
    rules switch to dp-all), ``rules_mode`` default | dp-all | megatron,
    ``remat``."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    specs = input_specs(cfg, shape)
    aparams = abstract_params(cfg)
    knobs = {"param_mode": param_mode, "batch_mode": batch_mode,
             "rules_mode": rules_mode, "remat": remat}
    if shape.kind == "train":
        opt = Optimizer(OptimizerConfig())
        params, state, batch, policy = sharded.place_train(
            cfg, mesh, aparams, opt, specs, param_mode=param_mode,
            batch_mode=batch_mode)
        step = make_train_step(cfg, opt, remat=remat)
        args = (params, state, batch)
        n_tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        params, batch, policy = sharded.place_prefill(
            cfg, mesh, aparams, specs, param_mode=param_mode,
            batch_mode=batch_mode)
        step = make_prefill_step(cfg, max_len=shape.seq_len)
        args = (params, batch, None)
        n_tokens = shape.global_batch * shape.seq_len
    else:
        params, cache, tokens, policy = sharded.place_decode(
            cfg, mesh, aparams, specs["cache"], specs["tokens"],
            param_mode=param_mode)
        step = make_serve_step(cfg)
        args = (params, cache, tokens, specs["pos"], specs["rng"])
        n_tokens = shape.global_batch
    mem = {"argument_size_in_bytes": local_tensor_bytes(args)}
    t0 = time.perf_counter()
    with sharded.on_mesh(mesh, sharded.rules_for(batch_mode, rules_mode)):
        cost, coll, out = mesh_cost_analysis(step, *args)
    mem["output_size_in_bytes"] = local_tensor_bytes(out)
    return {"kind": shape.kind, "n_tokens": n_tokens,
            "variant_knobs": knobs, "param_policy": policy,
            "run_s": round(time.perf_counter() - t0, 2),
            "cost_analysis": cost, "memory_analysis": mem,
            "collective_bytes": parse_collective_bytes(coll),
            "collective_ops": count_collective_ops(coll)}


def record_mesh_cell(cfg: ModelConfig, shape_name: str, *,
                     multi_pod: bool, variant: str = "", **knobs) -> Dict:
    """One cell's record on a production mesh (``ok``, ``skipped`` or
    ``error``)."""
    shape = SHAPES[shape_name]
    record: Dict = {"arch": cfg.name, "shape": shape_name,
                    "mesh": mesh_name(multi_pod), "kind": shape.kind,
                    "variant": variant}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        record.update({"status": "skipped", "reason": reason})
        return record
    try:
        mesh = production_mesh(multi_pod)
        n_chips = mesh.size()
        got = lower_cell(cfg, shape, mesh, **knobs)
        mem = got["memory_analysis"]
        io_bytes = float(mem["argument_size_in_bytes"]
                         + mem["output_size_in_bytes"])
        record.update({
            "status": "ok", "n_chips": n_chips,
            **{k: got[k] for k in ("param_policy", "variant_knobs", "run_s",
                                   "cost_analysis", "memory_analysis",
                                   "collective_bytes", "collective_ops")},
            "fits_one_card": io_bytes <= HW["hbm_bytes"],
            "roofline": summarize_cell(cfg, shape.kind, got["n_tokens"],
                                       n_chips, got["cost_analysis"],
                                       got["collective_bytes"],
                                       io_bytes=io_bytes),
        })
    except Exception as e:   # recorded per cell; main() exits 1 on any
        record.update({
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        })
    return record


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
             force: bool = False, multi_pod: Optional[bool] = None,
             variant: str = "", **knobs) -> Dict:
    """``record_cell`` of the published config of ``arch`` (with
    ``multi_pod`` False or True: ``record_mesh_cell`` on that mesh),
    written to ``<out_dir>/<cell>.json`` (read back instead when it
    exists and not ``force``)."""
    if multi_pod is None:
        cell = _cell_id(arch, shape_name)
    else:
        cell = f"{arch}__{shape_name}__{'multipod' if multi_pod else 'pod'}"
        cell += f"__{variant}" if variant else ""
    path = os.path.join(out_dir, cell + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    if multi_pod is None:
        record = record_cell(get_config(arch), shape_name)
    else:
        record = record_mesh_cell(get_config(arch), shape_name,
                                  multi_pod=multi_pod, variant=variant,
                                  **knobs)
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
    return (f"[{status:7s}] {rec['arch']} x {rec['shape']} x "
            f"{rec['mesh']}{extra}")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCHS} or 'all' or comma list")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all' or comma list")
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi", "both"],
                    help="card: one H100; single: 16x16; multi: 2x16x16")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"card": [None], "single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                rec = run_cell(arch, shape, out_dir=args.out,
                               force=args.force, multi_pod=multi)
                failures += rec["status"] == "error"
                print(status_line(rec), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
