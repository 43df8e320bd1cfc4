"""The scheduler's decisions worked out again from the run's event log,
in plain Python: each admission estimate (the paper's Eq. 1-2, with the
per-category bias of Eq. 5-6 fed by every completion before it) and
each dispatch under the cell's policy: shortest-job-first (smallest
estimated budget, ties to the earlier admission) or FIFO (the earliest
admission).

The constants are the paper's (Sec. II-C, III-B) as the port's
``DriftConfig`` defaults state them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

T_BASE = {"short_qa": 64.0, "summary": 288.0, "technical": 416.0,
          "report": 600.0}
SAFETY = {"premium": 1.15, "standard": 1.05, "batch": 1.0}
EMA_ALPHA = 0.10
BIAS_CLIP = (0.1, 4.0)
F_REF, F_SLOPE, F_CLIP = 6.0, 0.10, (0.90, 1.40)


def f_input(prompt_tokens: int) -> float:
    ratio = max(float(prompt_tokens), 1.0) / F_REF
    return min(max(1.0 + F_SLOPE * math.log2(ratio), F_CLIP[0]), F_CLIP[1])


ORDER = {"sjf": lambda budget, seq: (budget, seq),
         "fifo": lambda budget, seq: (seq,)}


def replay(log: Sequence[Tuple], info: Dict[int, Dict],
           policy: str) -> List[str]:
    """Walk ``log`` — ``("submit", rid)``, ``("dispatch", rid)``,
    ``("complete", rid, observed_tokens)`` in the order they happened —
    with ``info[rid]`` holding ``category``, ``tenant``, ``prompt_tokens``
    and the program's ``t_budget``, under ``policy`` (a key of
    ``ORDER``). Returns one line per disagreement."""
    key = ORDER[policy]
    bias = {c: 1.0 for c in T_BASE}
    budget: Dict[int, float] = {}
    seq: Dict[int, int] = {}
    queued = set()
    wrong: List[str] = []
    for ev in log:
        kind, rid = ev[0], ev[1]
        r = info[rid]
        if kind == "submit":
            cat = r["category"]
            est = (T_BASE[cat] * bias[cat] * SAFETY[r["tenant"]]
                   * f_input(r["prompt_tokens"]))
            budget[rid] = float(r["prompt_tokens"]) + est
            seq[rid] = len(seq)
            queued.add(rid)
            if not math.isclose(r["t_budget"], budget[rid], rel_tol=1e-12):
                wrong.append(f"estimate of {rid}: {r['t_budget']} "
                             f"against {budget[rid]}")
        elif kind == "dispatch":
            if rid not in queued:
                wrong.append(f"dispatch of {rid}, not queued")
                continue
            best = min(queued, key=lambda q: key(budget[q], seq[q]))
            if best != rid:
                wrong.append(f"dispatch of {rid} where {policy} takes {best}")
            queued.discard(rid)
        elif kind == "complete":
            cat = r["category"]
            measured = min(max(ev[2] / T_BASE[cat], BIAS_CLIP[0]),
                           BIAS_CLIP[1])
            bias[cat] = (1.0 - EMA_ALPHA) * bias[cat] + EMA_ALPHA * measured
        else:
            raise ValueError(kind)
    return wrong
