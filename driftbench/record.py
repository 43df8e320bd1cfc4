"""What one run recorded, and the arithmetic over its window that the
metric readers share. Nothing here imports torch or the program.

Times are seconds on the harness's monotonic clock, counted from the
start of the traffic. The window is ``[t_open, t_close)``: a request
counts when it was due inside it, a token when it was stamped inside
it. A request still waiting at the close counts with the wait it has
had so far.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0..100), linear between order
    statistics (numpy's default rule); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclass
class ReqLog:
    """One request: its record, the program's request object, and the
    tokens the harness saw with the time each was stamped."""

    rec: object                  # gen.traffic.Record
    req: object                  # the program's Request
    bucket: int
    target: int
    tokens: List[int] = field(default_factory=list)
    stamps: List[float] = field(default_factory=list)


@dataclass
class Call:
    """One traced call into the model: host wall (the call and its
    device work, synchronised), model FLOPs of its live tokens, whether
    it ran inside the profiled sub-window, and the prefill's bucket."""

    t0: float
    t1: float
    flops: float
    profiled: bool
    bucket: int = 0


@dataclass
class Run:
    cell: object                 # bench.Cell
    seed: int
    t_open: float
    t_close: float
    setup_s: float
    reqs: Dict[int, ReqLog]
    steps: List[Tuple[float, float, int, bool]]   # t0, t1, tokens, profiled
    prefills: List[Call] = field(default_factory=list)
    decodes: List[Call] = field(default_factory=list)
    trace: Optional[Dict] = None  # trace.reduce's summary
    sched_log: List[Tuple] = field(default_factory=list)
    # the engine's and scheduler's counters at the open and the close
    counters: Tuple[Dict, Dict] = ({}, {})
    engine: object = None         # the program's engine, until freed
    prof: object = None           # the profiler of the sub-window

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def due_in_window(self) -> List[ReqLog]:
        return [r for r in self.reqs.values()
                if self.t_open <= r.rec.due < self.t_close]

    def ttfts(self) -> List[float]:
        """Due time to first token (or to the close) of each request
        due in the window."""
        out = []
        for r in self.due_in_window():
            first = r.stamps[0] if r.stamps else math.inf
            out.append(min(first, self.t_close) - r.rec.due)
        return out

    def token_gaps(self) -> List[float]:
        """Every gap between consecutive tokens of a request due in the
        window, up to the close; a request that has started and not
        finished at the close adds its open gap."""
        out = []
        for r in self.due_in_window():
            seen = [t for t in r.stamps if t < self.t_close]
            out.extend(b - a for a, b in zip(seen, seen[1:]))
            if seen and len(seen) < r.target:
                out.append(self.t_close - seen[-1])
        return out

    def tokens_in_window(self) -> int:
        return sum(1 for r in self.reqs.values() for t in r.stamps
                   if self.t_open <= t < self.t_close)

    def window_steps(self, unprofiled: bool = False):
        return [s for s in self.steps
                if self.t_open <= s[0] and s[1] <= self.t_close
                and not (unprofiled and s[3])]

    def window_calls(self, calls: Sequence[Call], unprofiled: bool = False):
        return [c for c in calls
                if self.t_open <= c.t0 and c.t1 <= self.t_close
                and not (unprofiled and c.profiled)]
