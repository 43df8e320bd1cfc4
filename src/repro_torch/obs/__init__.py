"""Observability: lifecycle tracing, streaming telemetry, SLO monitors.

The instrument layer every execution surface emits into (DESIGN: the
paper's central claim is that *runtime observation* should drive
scheduling; this package is what makes runtime state observable):

* :mod:`events`   — typed lifecycle events + the bounded ring-buffer
  :class:`TraceRecorder` (counter-strided sampling, zero-overhead
  :class:`NullRecorder` default);
* :mod:`stats`    — exact percentile/Jain/LatencyStats helpers shared
  with ``serving.metrics`` (which re-exports them);
* :mod:`series`   — streaming windowed aggregates (P² quantiles,
  sliding-window rates, gauges);
* :mod:`slo`      — per-tenant-tier SLO targets with multi-window
  burn-rate monitors (report-only probes);
* :mod:`timeline` — Chrome-trace-event (Perfetto) export + structural
  validation;
* :mod:`report`   — ``python -m repro.obs.report`` trace summary CLI.

**Recorder plumbing.** Components accept an explicit ``trace=``
recorder; when omitted they resolve the process-global recorder at
construction time (:func:`get_recorder`, default the no-op
:data:`NULL_RECORDER`). ``benchmarks/run.py --trace`` installs a live
recorder via :func:`set_recorder` before any benchmark constructs a
simulator/engine, which is how a whole benchmark run gets traced
without threading a parameter through every layer.

**Determinism.** Tracing never touches a simulation RNG (sampling is
counter-strided) and never changes control flow, so traced runs are
bit-identical to untraced runs on the same seed — locked by
``tests/test_obs.py``.
"""

from __future__ import annotations

from .events import (DEFAULT_SAMPLE_EVERY, EVENT_KINDS, NULL_RECORDER,
                     NullRecorder, TraceEvent, TraceRecorder,
                     validate_lifecycles)
from .series import P2Quantile, SeriesBank, SlidingWindow, StreamSummary
from .slo import DEFAULT_TARGETS, SloMonitor, SloTarget
from .stats import LatencyStats, jain_index, percentile
from .timeline import (to_chrome_trace, validate_chrome_trace,
                       write_chrome_trace)

_active = NULL_RECORDER


def get_recorder():
    """The process-global recorder (the no-op sentinel by default)."""
    return _active


def set_recorder(recorder):
    """Install ``recorder`` as the process-global default (None resets
    to the no-op sentinel). Returns the installed recorder. Components
    resolve the global at *construction* time — install before building
    the simulators/engines that should emit into it."""
    global _active
    _active = recorder if recorder is not None else NULL_RECORDER
    return _active


def resolve_recorder(trace):
    """Constructor helper: an explicit recorder wins; None falls back
    to the process-global one."""
    return trace if trace is not None else _active


__all__ = [
    "DEFAULT_SAMPLE_EVERY", "DEFAULT_TARGETS", "EVENT_KINDS",
    "LatencyStats", "NULL_RECORDER", "NullRecorder", "P2Quantile",
    "SeriesBank", "SlidingWindow", "SloMonitor", "SloTarget",
    "StreamSummary", "TraceEvent", "TraceRecorder", "get_recorder",
    "jain_index", "percentile", "resolve_recorder", "set_recorder",
    "to_chrome_trace", "validate_chrome_trace", "validate_lifecycles",
    "write_chrome_trace",
]
