"""Where the benchmark's items live, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and lists the metrics. Each item has a
file of its own under ``driftbench/``:

* ``configs/<config>.json`` — the model as it is run (named by the
  configuration's ``file`` entry), with the reference family that
  checks it and counts its FLOPs (``reference/<family>.py``);
* ``traffic/<mix>.json`` — request content and arrival process;
* ``cells/<cell>.json`` — the engine's settings, the scheduling
  policy, the offered rate, the traffic warm-up, the check's sample and
  limits;
* ``metrics/<metric>.py`` — one reader a metric, ``read(run)``.

A later change adds a cell, configuration, mix or metric by adding a
file and an entry; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent


def manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: Dict          # configs/<config>.json
    traffic: Dict         # traffic/<mix>.json
    spec: Dict            # cells/<cell>.json
    chips: int

    @property
    def sizes(self) -> Dict:
        """The model's sizes, as the FLOP counts and the reference read
        them."""
        return self.config["model"]

    @property
    def reference(self):
        """``reference/<family>.py``: the plain model (``draw``,
        ``final_hidden``, ``logits``) and its FLOP counts."""
        return importlib.import_module(
            f"driftbench.reference.{self.config['reference']}")


def load_cell(name: str, root: Path = ROOT,
              man: Optional[Dict] = None) -> Cell:
    man = man or manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        known = [w["name"] for w in man["workloads"]]
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {known}")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    return Cell(name=name, config_name=entry["config"],
                traffic_name=entry["traffic"],
                config=_json(root / conf["file"]),
                traffic=_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
                spec=_json(BENCH / "cells" / f"{name}.json"),
                chips=int(entry["chips"]))


def metrics_for(cell: str, traced: bool, man: Dict) -> List[Dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``; a metric with
    a ``workloads`` list only in those cells."""
    group = man["per_layer"] if traced else man["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"driftbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
