"""Summarize a Chrome-trace file produced by ``benchmarks/run.py
--trace`` (or :func:`repro.obs.timeline.write_chrome_trace`).

    PYTHONPATH=src python -m repro.obs.report TRACE.json

Validates the file against the trace-event structural contract first
(:func:`~repro.obs.timeline.validate_chrome_trace`) and exits non-zero
on any violation — this CLI is the CI gate for exported traces. On a
valid file it prints track/slice/counter/flow inventories, slice-
duration percentiles per slice name, and the embedded recorder stats
(events emitted per kind, sampling strides, ring overflow), ending
with a ``trace OK`` line the CI grep guard keys on.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter, defaultdict
from typing import Dict, List

from .stats import percentile
from .timeline import validate_chrome_trace

_US = 1_000_000.0


def summarize(doc: dict) -> str:
    evs = doc.get("traceEvents", [])
    by_ph = Counter(e.get("ph") for e in evs)
    tracks = {(e.get("pid"), e.get("tid")) for e in evs
              if e.get("ph") != "M"}
    pids = {e.get("pid") for e in evs}
    lines = [
        f"events: {len(evs)}  "
        f"(slices={by_ph.get('X', 0)} instants={by_ph.get('i', 0)} "
        f"counters={by_ph.get('C', 0)} "
        f"flows={by_ph.get('s', 0)}+{by_ph.get('f', 0)} "
        f"metadata={by_ph.get('M', 0)})",
        f"tracks: {len(tracks)} across {len(pids)} process groups",
    ]

    durs: Dict[str, List[float]] = defaultdict(list)
    for e in evs:
        if e.get("ph") == "X":
            name = e.get("cat") or e.get("name", "?")
            durs[name].append(float(e.get("dur", 0.0)) / _US)
    for name in sorted(durs):
        xs = durs[name]
        lines.append(
            f"  {name}: n={len(xs)} "
            f"mean={sum(xs) / len(xs):.3f}s "
            f"p50={percentile(xs, 50):.3f}s "
            f"p95={percentile(xs, 95):.3f}s "
            f"max={max(xs):.3f}s")

    counters = Counter(e.get("name") for e in evs if e.get("ph") == "C")
    if counters:
        lines.append("counters: " + ", ".join(
            f"{n} ({c} samples)" for n, c in sorted(counters.items())))
    instants = Counter(e.get("name") for e in evs if e.get("ph") == "i")
    if instants:
        lines.append("markers: " + ", ".join(
            f"{n}={c}" for n, c in sorted(instants.items())))

    rec = (doc.get("otherData") or {}).get("recorder")
    if rec:
        lines.append(
            f"recorder: emitted={rec.get('emitted')} "
            f"recorded={rec.get('recorded')} "
            f"overflow_dropped={rec.get('dropped_overflow')}")
        by_kind = rec.get("by_kind") or {}
        if by_kind:
            lines.append("  by kind: " + ", ".join(
                f"{k}={v}" for k, v in sorted(by_kind.items())))
        strides = {k: v for k, v in (rec.get("sample_every")
                                     or {}).items() if v != 1}
        if strides:
            lines.append("  sampled: " + ", ".join(
                f"{k} 1:{v}" for k, v in sorted(strides.items())))
        segs = rec.get("segments") or []
        if segs:
            lines.append(f"  segments: {len(segs)} "
                         f"({', '.join(segs[:6])}"
                         f"{', ...' if len(segs) > 6 else ''})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="Chrome trace-event JSON file "
                                  "(benchmarks/run.py --trace output)")
    args = ap.parse_args(argv)
    try:
        with open(args.trace) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot load {args.trace}: {e}", file=sys.stderr)
        return 2
    problems = validate_chrome_trace(doc)
    if problems:
        print(f"INVALID trace ({len(problems)} problems):",
              file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    print(f"trace: {args.trace}")
    print(summarize(doc))
    print(f"trace OK: {args.trace} is a valid Chrome trace-event file")
    return 0


if __name__ == "__main__":
    sys.exit(main())
