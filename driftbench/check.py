"""What decides ``correct``: the timed path's own output, held to the
plain reference after the window has closed.

* ``logit_gap`` — a sample of the requests the engine finished, drawn
  from the seed with the longest among them. The reference runs each
  prompt (as the engine tokenised it) with its served tokens once, in
  float32; at every served position it reads how far the served
  token's logit lies below the best. The number is the widest such gap.
  Greedy decoding serves the program's own best token, so a sound
  program reads only its rounding there.
* ``accounting`` — every request emits exactly its target (the oracle
  end of sequence), is dispatched and completed at most once, and
  nothing is lost: the count of breaches, limit 0.
* ``scheduler`` — the admission estimates and the dispatch order of
  the cell's policy worked out again from the run's event log
  (``reference/sched.py``): the count of disagreements, limit 0.

The control (``gaps(..., control=True)``) puts the reference in the program's
place one precision lower (fp8 products, for a bf16 configuration): at
each position of the same prompts and served tokens it takes the token
the fp8 reference puts first, and reads that token's gap in the float32
reference.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Sequence, Tuple

import torch

from .record import ReqLog, Run
from .reference import sched as ref_sched
from .reference.common import full_float32
from .reference.tokens import prompt_ids

SAMPLE = 16          # finished requests the reference reruns a run


def sample(run: Run, k: int, seed: int) -> List[ReqLog]:
    """``k`` finished requests drawn from the seed, the two longest
    among them."""
    done = [r for r in run.reqs.values() if r.req.completion_time is not None]
    done.sort(key=lambda r: (-len(r.tokens), r.rec.due))
    picked, rest = done[:2], done[2:]
    rng = random.Random(seed)
    picked += rng.sample(rest, min(k - len(picked), len(rest)))
    return picked


def _positions(c: Dict, engine: Dict, r: ReqLog, device):
    ids = prompt_ids(r.rec, engine["prompt_buckets"], c["vocab"],
                     bool(engine.get("prefix_cache")))
    seq = torch.tensor(ids + r.tokens[:-1], dtype=torch.long, device=device)
    pos = torch.arange(len(ids) - 1, len(ids) - 1 + len(r.tokens),
                       device=device)
    return seq, pos, torch.tensor(r.tokens, dtype=torch.long, device=device)


def gaps(run: Run, fam, params, picked: Sequence[ReqLog],
         control: bool = False) -> List[Tuple[float, float]]:
    """Per request: (the served tokens' widest gap, and with ``control``
    the fp8 reference's first choices' widest gap, else nan), both read
    in the float32 reference."""
    c = run.cell.sizes
    engine = run.cell.spec["engine"]
    device = params["embed"]["table"].device
    out = []
    with full_float32(), torch.no_grad():
        for r in picked:
            seq, pos, served = _positions(c, engine, r, device)
            lg = fam.logits(c, params, fam.final_hidden(c, params, seq)[pos])
            best = lg.max(-1).values
            g = (best - lg.gather(1, served[:, None])[:, 0]).max().item()
            gc = float("nan")
            if control:
                low = fam.logits(c, params, fam.final_hidden(
                    c, params, seq, low=True)[pos], low=True)
                pick = low.argmax(-1)
                gc = (best - lg.gather(1, pick[:, None])[:, 0]).max().item()
            out.append((g, gc))
    return out


def accounting(run: Run) -> List[Tuple[int, str]]:
    """Breaches of the engine's accounting: (request, what)."""
    bad = []
    dispatched: Dict[int, int] = {}
    completed: Dict[int, int] = {}
    for ev in run.sched_log:
        if ev[0] == "dispatch":
            dispatched[ev[1]] = dispatched.get(ev[1], 0) + 1
        elif ev[0] == "complete":
            completed[ev[1]] = completed.get(ev[1], 0) + 1
            if ev[1] not in dispatched:
                bad.append((ev[1], "completed, never dispatched"))
    bad += [(rid, f"dispatched {n} times") for rid, n in dispatched.items()
            if n > 1]
    bad += [(rid, f"completed {n} times") for rid, n in completed.items()
            if n > 1]
    for rid, r in run.reqs.items():
        n = len(r.tokens)
        if r.req.completion_time is not None:
            if n != r.target or r.req.observed_output_tokens != r.target:
                bad.append((rid, f"finished with {n} tokens seen, "
                                 f"{r.req.observed_output_tokens} counted, "
                                 f"target {r.target}"))
        elif n >= r.target:
            bad.append((rid, f"{n} of {r.target} tokens, not retired"))
        elif n and rid not in dispatched:
            bad.append((rid, "has tokens, never dispatched"))
    return bad


def scheduler(run: Run) -> List[str]:
    info = {rid: dict(category=r.rec.category, tenant=r.rec.tenant,
                      prompt_tokens=r.rec.prompt_tokens,
                      t_budget=r.req.estimate.t_budget)
            for rid, r in run.reqs.items()}
    return ref_sched.replay(run.sched_log, info, run.cell.spec["policy"])


def verify(run: Run, fam, params, seed: int) -> Tuple[bool, Dict, Dict]:
    """(correct, each number beside its limit, details for the log)."""
    limits = run.cell.spec["limits"]
    picked = sample(run, SAMPLE, seed)
    per = gaps(run, fam, params, picked)
    vals = [g for g, _ in per]
    gap = max(vals) if vals and all(math.isfinite(g) for g in vals) \
        else float("inf")
    acc, sch = accounting(run), scheduler(run)
    checks = {
        "logit_gap": {"value": gap, "limit": limits["logit_gap"]},
        "accounting": {"value": len(acc), "limit": 0},
        "scheduler": {"value": len(sch), "limit": 0},
    }
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    details = {"sampled": len(picked),
               "sampled_tokens": sum(len(r.tokens) for r in picked),
               "gaps": [round(g, 5) for g in vals],
               "accounting": acc, "scheduler": sch}
    return ok, checks, details
