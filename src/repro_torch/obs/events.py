"""Typed request-lifecycle trace events + the bounded ring recorder.

The observability substrate every execution layer emits into:

* :class:`TraceEvent` — one timestamped, typed event (``kind`` from
  :data:`EVENT_KINDS`), optionally bound to a request / replica /
  tenant, carrying a small ``data`` payload.
* :class:`TraceRecorder` — bounded ring buffer with per-kind stride
  sampling. Sampling is **counter-based** (every Nth emission of a
  kind), never RNG-based: tracing must not touch any simulation RNG,
  which is what keeps traced runs bit-identical to untraced ones.
  Observers (:class:`~repro.obs.series.SeriesBank`,
  :class:`~repro.obs.slo.SloMonitor`) see every emission *before*
  sampling, so streaming aggregates are exact even when the ring keeps
  only every 32nd ``decode_step``.
* :class:`NullRecorder` — the zero-overhead default. Its class-level
  ``enabled = False`` is the single attribute check hot paths pay when
  tracing is off (``if self.trace.enabled: ...``).
* :class:`Span` — one region of the program timed on the host clock
  (``time.perf_counter_ns``), opened by ``with recorder.span(name):``
  (names from :data:`SPAN_NAMES`). Spans nest (one thread, so a stack:
  each knows the id of the span open around it) and are never sampled.
  While a ``torch.profiler`` session is active a span also opens a
  ``record_function`` range of its name, so the program's spans sit on
  the device trace's clock; outside one, no range is opened.
  ``NullRecorder.span`` hands back the shared no-op :data:`NULL_SPAN`.

This file is a port of the JAX package's ``obs/events.py``: the events,
the ring and the lifecycle check are the original's; the spans are the
port's own (the JAX package has no host-clock spans).

Emission ordering contract: components emit events in causal order at
the simulated timestamp they happen, so for any one request the event
sequence is non-decreasing in ``ts`` and :func:`validate_lifecycles`
can check chains without re-sorting.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

# --- event taxonomy ----------------------------------------------------
ARRIVE = "arrive"                 # request hits the front door
ADMIT = "admit"                   # admission accepted (est priced)
SHED = "shed"                     # admission rejected (data: reason)
ROUTE = "route"                   # router placed it (data: stage)
PREFILL_CHUNK = "prefill_chunk"   # one prompt chunk consumed (data: tokens)
FIRST_TOKEN = "first_token"       # honest TTFT anchor (data: ttft)
DECODE_STEP = "decode_step"       # one decode token (ring-sampled)
HANDOFF = "handoff"               # P/D KV transfer (data: edge=out|in)
STEAL = "steal"                   # work stealing moved it (victim/thief)
PREFIX_HIT = "prefix_hit"         # joined with resident prefix pages
PREFIX_MISS = "prefix_miss"       # shareable prefix, nothing resident
PREFIX_EVICT = "prefix_evict"     # LRU eviction freed pages (data: pages)
PREEMPT = "preempt"               # failure aborted in-flight work
COMPLETE = "complete"             # retired (data: observed, e2e, ttft)
SCALE_UP = "scale_up"             # autoscaler decision
SCALE_DOWN = "scale_down"
REPLICA_FAIL = "replica_fail"     # whole replica left the pool
REPLICA_RECOVER = "replica_recover"
WORKER_FAIL = "worker_fail"       # one worker inside a replica died
WORKER_REPAIR = "worker_repair"
DRIFT = "drift"                   # drift sample (data: abs_error, phase)
GAUGE = "gauge"                   # sampled scalar (data: name, value)

EVENT_KINDS = frozenset({
    ARRIVE, ADMIT, SHED, ROUTE, PREFILL_CHUNK, FIRST_TOKEN, DECODE_STEP,
    HANDOFF, STEAL, PREFIX_HIT, PREFIX_MISS, PREFIX_EVICT, PREEMPT,
    COMPLETE, SCALE_UP, SCALE_DOWN, REPLICA_FAIL, REPLICA_RECOVER,
    WORKER_FAIL, WORKER_REPAIR, DRIFT, GAUGE,
})

#: kinds that fire once per decoded token / control tick — the only
#: ones worth thinning by default. Everything else records 1:1.
DEFAULT_SAMPLE_EVERY: Dict[str, int] = {DECODE_STEP: 32, GAUGE: 8}

# --- span taxonomy -----------------------------------------------------
ENGINE_STEP = "engine.step"             # ServingEngine.step, whole
ENGINE_ADMIT = "engine.admit"           # dispatch + tokenise + H2D copy
ENGINE_PREFILL = "engine.prefill"       # one device prefill (or chunk)
ENGINE_INSERT_CACHE = "engine.insert_cache"   # prefill cache -> slot/pages
ENGINE_FIRST_TOKEN = "engine.first_token"     # ends when it is on the host
ENGINE_DECODE = "engine.decode"         # the decode half of a step
ENGINE_SAMPLE = "engine.sample"         # ends when the tokens are on the host
ENGINE_RETIRE = "engine.retire"
CORE_DISPATCH = "core.dispatch"         # DriftScheduler.dispatch
CORE_COMPLETE = "core.complete"         # DriftScheduler.complete (Eq. 5-6)
MODEL_PREFILL = "model.prefill"         # the model's prefill call
MODEL_DECODE = "model.decode"           # the model's decode call
OPS_ATTENTION = "ops.attention"         # kernels/ops.py wrappers
OPS_DECODE_ATTENTION = "ops.decode_attention"
OPS_SSD_WITH_STATE = "ops.ssd_with_state"
OPS_SSM_DECODE_STEP = "ops.ssm_decode_step"
KERNELS_BUILD = "kernels.build"         # a kernel's first-use build + load

SPAN_NAMES = frozenset({
    ENGINE_STEP, ENGINE_ADMIT, ENGINE_PREFILL, ENGINE_INSERT_CACHE,
    ENGINE_FIRST_TOKEN, ENGINE_DECODE, ENGINE_SAMPLE, ENGINE_RETIRE,
    CORE_DISPATCH, CORE_COMPLETE, MODEL_PREFILL, MODEL_DECODE,
    OPS_ATTENTION, OPS_DECODE_ATTENTION, OPS_SSD_WITH_STATE,
    OPS_SSM_DECODE_STEP, KERNELS_BUILD,
})


@dataclass
class TraceEvent:
    """One recorded lifecycle event. ``seq`` is the global emission
    index (pre-sampling, so gaps reveal what the ring thinned out);
    ``seg`` groups events by run segment (see
    :meth:`TraceRecorder.begin_segment`)."""

    seq: int
    ts: float
    kind: str
    req_id: Optional[int] = None
    rid: Optional[int] = None      # replica id (None = cluster scope)
    tenant: Optional[str] = None   # tenant tier label
    seg: int = 0
    data: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        out = {"seq": self.seq, "ts": self.ts, "kind": self.kind,
               "seg": self.seg}
        if self.req_id is not None:
            out["req_id"] = self.req_id
        if self.rid is not None:
            out["rid"] = self.rid
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.data:
            out["data"] = dict(self.data)
        return out


class Span:
    """One span (see the module doc): ``name``, its ``id`` and its
    ``parent``'s (None at the top), start and end in
    ``time.perf_counter_ns`` nanoseconds, what the caller gave in
    ``data`` (``ops.attention`` gives its shape), and ``ranged`` when a
    profiler range of the same name was opened with it. The span is its
    own context manager; :meth:`TraceRecorder.span` makes it."""

    __slots__ = ("name", "id", "parent", "t0_ns", "t1_ns", "ranged",
                 "data", "_rec", "_range")

    def __init__(self, rec: "TraceRecorder", name: str, span_id: int,
                 data: dict) -> None:
        self.name = name
        self.id = span_id
        self.parent: Optional[int] = None
        self.t0_ns = self.t1_ns = 0
        self.ranged = False
        self.data = data
        self._rec = rec
        self._range = None

    @property
    def dur_ns(self) -> int:
        return self.t1_ns - self.t0_ns

    def __enter__(self) -> "Span":
        stack = self._rec._stack
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            self.ranged = True
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._rec._close(self)
        return False


class _NullSpan:
    """The span of a recorder that is off: enters, exits and records
    nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class NullRecorder:
    """Tracing-off sentinel: hot paths check ``enabled`` once and skip
    every emission. All methods are harmless no-ops so accidental calls
    on the sentinel cannot crash an untraced run."""

    enabled = False

    def emit(self, ts: float, kind: str, **kw) -> None:
        pass

    def span(self, name: str, **data) -> _NullSpan:
        return NULL_SPAN

    def spans(self) -> List[Span]:
        return []

    def begin_segment(self, label: str) -> int:
        return 0

    def add_observer(self, observer) -> None:
        pass

    def events(self) -> List[TraceEvent]:
        return []

    def stats(self) -> dict:
        return {"emitted": 0, "recorded": 0, "dropped_overflow": 0,
                "by_kind": {}, "sample_every": {}, "segments": []}


NULL_RECORDER = NullRecorder()


class TraceRecorder:
    """Bounded ring of :class:`TraceEvent` with per-kind stride sampling.

    ``capacity`` bounds memory (oldest events drop first);
    ``sample_every`` maps kind -> stride N (record every Nth emission,
    deterministic counter — the first emission of a kind always
    records). Kinds absent from the map record 1:1; pass explicit ``1``
    strides to force full fidelity for the thinned defaults
    (:data:`DEFAULT_SAMPLE_EVERY`).

    Observers receive *every* emission (pre-sampling) via
    ``observer.on_event(ev)`` — streaming aggregates must not be
    subject to ring thinning or overflow. Spans are kept in a ring of
    their own of the same ``capacity``, never sampled.
    """

    enabled = True

    def __init__(self, capacity: int = 500_000,
                 sample_every: Optional[Dict[str, int]] = None,
                 observers: Iterable = ()) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.sample_every = dict(DEFAULT_SAMPLE_EVERY)
        if sample_every:
            for k, n in sample_every.items():
                if k not in EVENT_KINDS:
                    raise ValueError(f"unknown event kind {k!r}")
                if n < 1:
                    raise ValueError(f"sample_every[{k!r}] must be >= 1")
                self.sample_every[k] = int(n)
        self._ring: deque = deque(maxlen=capacity)
        self._observers: List = list(observers)
        self._spans: deque = deque(maxlen=capacity)
        self._span_ids = itertools.count()
        self._stack: List[Span] = []
        self._seq = itertools.count()
        self._emitted: Dict[str, int] = {}
        self._recorded: Dict[str, int] = {}
        self._seg = 0
        self._segments: List[str] = []
        self.last_ts = 0.0

    # ------------------------------------------------------------------
    def add_observer(self, observer) -> None:
        self._observers.append(observer)

    def begin_segment(self, label: str) -> int:
        """Start a new run segment (one benchmark arm / one ``run()``).
        Events emitted afterwards carry the new segment index, which
        the timeline exporter maps to separate Perfetto process
        groups so sequential runs don't interleave on one track."""
        self._seg += 1
        self._segments.append(label)
        return self._seg

    def emit(self, ts: float, kind: str, *, req_id: Optional[int] = None,
             rid: Optional[int] = None, tenant: Optional[str] = None,
             **data) -> None:
        """Record one event (subject to per-kind stride sampling);
        observers always see it first."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}")
        ev = TraceEvent(seq=next(self._seq), ts=ts, kind=kind,
                        req_id=req_id, rid=rid, tenant=tenant,
                        seg=self._seg, data=data)
        if ts > self.last_ts:
            self.last_ts = ts
        for ob in self._observers:
            ob.on_event(ev)
        n = self._emitted.get(kind, 0)
        self._emitted[kind] = n + 1
        stride = self.sample_every.get(kind, 1)
        if n % stride == 0:
            self._ring.append(ev)
            self._recorded[kind] = self._recorded.get(kind, 0) + 1

    def span(self, name: str, **data) -> Span:
        """A span of ``name`` (from :data:`SPAN_NAMES`), to open with
        ``with``; ``data`` is kept with it."""
        if name not in SPAN_NAMES:
            raise ValueError(f"unknown span name {name!r}")
        return Span(self, name, next(self._span_ids), data)

    def _close(self, span: Span) -> None:
        self._stack.pop()
        self._spans.append(span)

    # ------------------------------------------------------------------
    def spans(self) -> List[Span]:
        """Closed spans, in the order they were opened."""
        return sorted(self._spans, key=lambda sp: sp.id)

    def events(self) -> List[TraceEvent]:
        """Ring contents, oldest first (post-sampling, post-overflow)."""
        return list(self._ring)

    def stats(self) -> dict:
        emitted = sum(self._emitted.values())
        recorded = sum(self._recorded.values())
        return {
            "emitted": emitted,
            "recorded": recorded,
            # sampled-in events the ring later overwrote (capacity)
            "dropped_overflow": recorded - len(self._ring),
            "by_kind": dict(sorted(self._emitted.items())),
            "sample_every": dict(self.sample_every),
            "segments": list(self._segments),
        }


# --- lifecycle validation ---------------------------------------------
#: kinds that terminate a request's chain
_TERMINAL = (COMPLETE, SHED)
#: per-request kinds that may only appear between admit and terminal
_EXEC_KINDS = (PREFILL_CHUNK, FIRST_TOKEN, DECODE_STEP, PREFIX_HIT,
               PREFIX_MISS)


def validate_lifecycles(events: Sequence[TraceEvent], *,
                        require_route: Optional[bool] = None,
                        require_terminal: bool = True) -> List[str]:
    """Check every request's event chain is a well-formed lifecycle.

    Returns a list of human-readable violations (empty = valid). The
    accepted grammar (events in emission order)::

        arrive -> [admit -> [route] -> exec*] -> (complete | shed)

    where ``exec*`` is any interleaving of prefill_chunk / first_token /
    decode_step / prefix_* / handoff / steal / preempt / route
    (reroutes), subject to:

    * the chain starts with ``arrive``;
    * nothing follows a terminal (``complete`` / ``shed``);
    * ``complete`` requires a prior ``admit``;
    * with ``require_route`` (default: auto — required iff any route
      event exists in the stream) a completed chain needs >= 1
      ``route`` before its first exec event;
    * ``first_token`` precedes ``complete``; ``prefill_chunk`` never
      follows ``first_token`` unless a ``preempt`` or ``handoff``
      intervened (re-prefill after failure is legal);
    * timestamps are non-decreasing along the chain.

    Run this against a full-fidelity recorder (stride-1 sampling, no
    ring overflow) — a thinned ring legitimately lacks links.
    ``require_terminal=False`` permits unterminated chains (runs
    stopped by ``max_time`` with work still queued).
    """
    chains: Dict[int, List[TraceEvent]] = {}
    any_route = False
    for ev in events:
        if ev.kind == ROUTE:
            any_route = True
        if ev.req_id is not None:
            chains.setdefault(ev.req_id, []).append(ev)
    if require_route is None:
        require_route = any_route

    problems: List[str] = []
    for req_id, chain in chains.items():
        kinds = [e.kind for e in chain]

        def bad(msg: str) -> None:
            problems.append(f"req {req_id}: {msg} (chain: {kinds})")

        if kinds[0] != ARRIVE:
            bad(f"chain starts with {kinds[0]!r}, not 'arrive'")
        for a, b in zip(chain, chain[1:]):
            if b.ts < a.ts:
                bad(f"ts regressed {a.ts} -> {b.ts} at {b.kind!r}")
                break
        terminals = [i for i, k in enumerate(kinds) if k in _TERMINAL]
        if not terminals:
            if require_terminal:
                bad("no terminal complete/shed")
            continue
        t = terminals[0]
        if len(terminals) > 1 or t != len(kinds) - 1:
            bad(f"events after terminal {kinds[t]!r}")
        if kinds[t] == COMPLETE:
            if ADMIT not in kinds[:t]:
                bad("complete without admit")
            exec_idx = [i for i, k in enumerate(kinds)
                        if k in _EXEC_KINDS]
            if require_route:
                first_route = kinds.index(ROUTE) if ROUTE in kinds else None
                if first_route is None:
                    bad("complete without route")
                elif exec_idx and first_route > exec_idx[0]:
                    bad("execution before first route")
            ft = [i for i, k in enumerate(kinds) if k == FIRST_TOKEN]
            for i, k in enumerate(kinds):
                if k == PREFILL_CHUNK and ft and i > ft[0]:
                    # legal only after a preempt/handoff reset re-ran
                    # prefill; otherwise the chain is out of order
                    between = kinds[ft[0]:i]
                    if PREEMPT not in between and HANDOFF not in between:
                        bad("prefill_chunk after first_token without "
                            "preempt/handoff")
                        break
    return problems
