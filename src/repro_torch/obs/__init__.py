"""Observability for the port: lifecycle events and latency statistics
(copies of the JAX package's ``obs.events`` / ``obs.stats``) plus the
process-global recorder plumbing engines resolve at construction time.
"""

from __future__ import annotations

from .events import (DEFAULT_SAMPLE_EVERY, EVENT_KINDS, NULL_RECORDER,
                     NullRecorder, TraceEvent, TraceRecorder,
                     validate_lifecycles)
from .stats import LatencyStats, jain_index, percentile

_active = NULL_RECORDER


def get_recorder():
    """The process-global recorder (the no-op sentinel by default)."""
    return _active


def set_recorder(recorder):
    """Install ``recorder`` as the process-global default (None resets
    to the no-op sentinel). Returns the installed recorder. Components
    resolve the global at *construction* time — install before building
    the engines that should emit into it."""
    global _active
    _active = recorder if recorder is not None else NULL_RECORDER
    return _active


def resolve_recorder(trace):
    """Constructor helper: an explicit recorder wins; None falls back
    to the process-global one."""
    return trace if trace is not None else _active


__all__ = [
    "DEFAULT_SAMPLE_EVERY", "EVENT_KINDS", "LatencyStats", "NULL_RECORDER",
    "NullRecorder", "TraceEvent", "TraceRecorder", "get_recorder",
    "jain_index", "percentile", "resolve_recorder", "set_recorder",
    "validate_lifecycles",
]
