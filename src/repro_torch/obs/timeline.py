"""Chrome-trace-event (Perfetto-loadable) export of a recorded trace.

Converts :class:`~repro.obs.events.TraceEvent` streams into the JSON
object format chrome://tracing and https://ui.perfetto.dev load
directly (see ``docs/observability.md`` for the walkthrough):

* one **process** (pid) per (segment, replica) pair — each benchmark
  arm gets its own process group, each replica its own track set, plus
  a cluster-scope track for front-door events;
* one **thread** (tid) per request inside its replica's process, so a
  request's lifetime renders as a horizontal slice;
* ``X`` complete slices: request lifetime (arrive -> complete/shed)
  and, when a TTFT anchor exists, the decode span (first_token ->
  complete);
* ``i`` instants: shed / steal / preempt / prefix_evict / scale /
  fail / repair markers;
* ``s``/``f`` flow pairs: P/D KV handoffs and stolen-work
  re-transfers draw arrows from source to destination replica;
* ``C`` counters: gauge events (queue depth per tier, slot occupancy,
  free pages, ...) render as counter tracks.

Timestamps are micro­seconds (the format's unit); the simulation's
seconds are scaled by 1e6. :func:`validate_chrome_trace` checks the
structural contract (required keys, non-negative durations, per-track
monotone ``ts``, balanced flows) and is what the CI smoke step and the
report CLI run against every exported file.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from . import events as ev

_US = 1_000_000.0   # trace-event ts unit: microseconds

#: per-request event kinds rendered as instant markers
_REQ_INSTANTS = (ev.SHED, ev.STEAL, ev.PREEMPT, ev.PREFIX_HIT,
                 ev.PREFIX_MISS, ev.HANDOFF)
#: scope-level kinds rendered as instant markers on the track's row 0
_SCOPE_INSTANTS = (ev.SCALE_UP, ev.SCALE_DOWN, ev.REPLICA_FAIL,
                   ev.REPLICA_RECOVER, ev.WORKER_FAIL, ev.WORKER_REPAIR,
                   ev.PREFIX_EVICT)


class _Tracks:
    """pid registry: (seg, rid) -> pid, with process_name metadata."""

    def __init__(self, segments: Sequence[str]) -> None:
        self._pids: Dict[Tuple[int, Optional[int]], int] = {}
        self._segments = list(segments)
        self.metadata: List[dict] = []

    def pid(self, seg: int, rid: Optional[int]) -> int:
        key = (seg, rid)
        if key not in self._pids:
            pid = len(self._pids) + 1
            self._pids[key] = pid
            label = (self._segments[seg - 1]
                     if 1 <= seg <= len(self._segments) else f"seg{seg}")
            where = "cluster" if rid is None else f"replica{rid}"
            self.metadata.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "ts": 0, "args": {"name": f"{label}/{where}"}})
            # replica tracks after the cluster track, stable within a
            # segment: sort_index mirrors rid
            self.metadata.append({
                "name": "process_sort_index", "ph": "M", "pid": pid,
                "tid": 0, "ts": 0,
                "args": {"sort_index": seg * 1000
                         + (-1 if rid is None else rid)}})
        return self._pids[key]


def to_chrome_trace(events: Sequence, *,
                    recorder_stats: Optional[dict] = None) -> dict:
    """Build the Chrome trace-event JSON object for ``events``
    (oldest-first :class:`TraceEvent` list, e.g. ``recorder.events()``)."""
    segments = (recorder_stats or {}).get("segments", [])
    tracks = _Tracks(segments)
    out: List[dict] = []
    flow_seq = 0

    # group per (seg, req_id) to build lifetime/decode slices and
    # pair handoff flows
    chains: Dict[Tuple[int, int], List] = {}
    for e in events:
        if e.req_id is not None:
            chains.setdefault((e.seg, e.req_id), []).append(e)

    for (seg, req_id), chain in chains.items():
        # the request's home track: where it last executed
        rid = next((e.rid for e in reversed(chain) if e.rid is not None),
                   None)
        pid = tracks.pid(seg, rid)
        first, last = chain[0], chain[-1]
        terminal = last.kind in (ev.COMPLETE, ev.SHED)
        if terminal and last.ts >= first.ts:
            args = {"kind": "lifetime", "tenant": first.tenant
                    or last.tenant or "?"}
            for k in ("observed", "e2e", "ttft", "reason"):
                if k in last.data and last.data[k] is not None:
                    args[k] = last.data[k]
            out.append({
                "name": f"req {req_id} ({args['tenant']})",
                "cat": "request", "ph": "X",
                "ts": first.ts * _US,
                "dur": max(last.ts - first.ts, 0.0) * _US,
                "pid": pid, "tid": req_id, "args": args})
        ft = next((e for e in chain if e.kind == ev.FIRST_TOKEN), None)
        if ft is not None and terminal and last.kind == ev.COMPLETE:
            out.append({
                "name": "decode", "cat": "phase", "ph": "X",
                "ts": ft.ts * _US,
                "dur": max(last.ts - ft.ts, 0.0) * _US,
                "pid": tracks.pid(seg, ft.rid if ft.rid is not None
                                  else rid),
                "tid": req_id, "args": {}})
        # flows: each handoff 'out' pairs with the next 'in'
        pending_out = None
        for e in chain:
            if e.kind != ev.HANDOFF:
                continue
            edge = e.data.get("edge")
            if edge == "out":
                pending_out = e
            elif edge == "in" and pending_out is not None:
                flow_seq += 1
                base = {"name": "handoff", "cat": "kv_transfer",
                        "id": flow_seq}
                out.append(dict(base, ph="s",
                                ts=pending_out.ts * _US,
                                pid=tracks.pid(seg, pending_out.rid),
                                tid=req_id))
                out.append(dict(base, ph="f", bp="e", ts=e.ts * _US,
                                pid=tracks.pid(seg, e.rid), tid=req_id))
                pending_out = None

    for e in events:
        pid = tracks.pid(e.seg, e.rid)
        ts = e.ts * _US
        if e.kind == ev.GAUGE:
            out.append({"name": e.data["name"], "cat": "gauge",
                        "ph": "C", "ts": ts, "pid": pid, "tid": 0,
                        "args": {"value": e.data["value"]}})
        elif e.req_id is not None and e.kind in _REQ_INSTANTS:
            out.append({"name": e.kind, "cat": "marker", "ph": "i",
                        "s": "t", "ts": ts, "pid": pid,
                        "tid": e.req_id, "args": dict(e.data)})
        elif e.req_id is None and e.kind in _SCOPE_INSTANTS:
            out.append({"name": e.kind, "cat": "marker", "ph": "i",
                        "s": "p", "ts": ts, "pid": pid, "tid": 0,
                        "args": dict(e.data)})

    out.sort(key=lambda d: (d["ts"], d["pid"], d["tid"]))
    doc = {"traceEvents": tracks.metadata + out,
           "displayTimeUnit": "ms"}
    if recorder_stats is not None:
        doc["otherData"] = {"recorder": recorder_stats}
    return doc


def write_chrome_trace(path: str, events: Sequence, *,
                       recorder_stats: Optional[dict] = None) -> dict:
    """Export ``events`` to ``path`` and return the written document.
    ``allow_nan=False`` makes any non-finite payload a loud error —
    a trace file that Perfetto rejects must never be written quietly."""
    doc = to_chrome_trace(events, recorder_stats=recorder_stats)
    with open(path, "w") as f:
        json.dump(doc, f, indent=None, separators=(",", ":"),
                  allow_nan=False)
    return doc


# --- structural validation ---------------------------------------------
_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


def validate_chrome_trace(doc: dict, *, max_problems: int = 20) -> List[str]:
    """Check a trace document against the Chrome trace-event contract:
    required keys on every event, numeric non-negative ``dur`` on X
    slices, monotone ``ts`` per (pid, tid) track, balanced s/f flow
    pairs. Returns human-readable problems (empty = valid)."""
    problems: List[str] = []

    def bad(msg: str) -> None:
        if len(problems) < max_problems:
            problems.append(msg)

    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    last_ts: Dict[Tuple[int, int], float] = {}
    flows: Dict[object, int] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            bad(f"event {i} is not an object")
            continue
        missing = [k for k in _REQUIRED_KEYS if k not in e]
        if missing:
            bad(f"event {i} ({e.get('name')!r}) missing keys {missing}")
            continue
        if not isinstance(e["ts"], (int, float)):
            bad(f"event {i} ts is not numeric")
            continue
        ph = e["ph"]
        if ph == "M":
            continue
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                bad(f"event {i} ({e['name']!r}) X slice with bad dur "
                    f"{dur!r}")
        if ph == "s":
            flows[e.get("id")] = flows.get(e.get("id"), 0) + 1
        elif ph == "f":
            flows[e.get("id")] = flows.get(e.get("id"), 0) - 1
        key = (e["pid"], e["tid"])
        if e["ts"] < last_ts.get(key, float("-inf")):
            bad(f"event {i} ({e['name']!r}) ts {e['ts']} regressed on "
                f"track pid={e['pid']} tid={e['tid']}")
        last_ts[key] = e["ts"]
    unbalanced = {k: v for k, v in flows.items() if v != 0}
    if unbalanced:
        bad(f"unbalanced flow pairs (id -> s minus f): {unbalanced}")
    return problems
