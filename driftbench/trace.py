"""The traced run's device trace: a ``torch.profiler`` sub-window of a
few seconds that ends the window, reduced to what the per-layer
metrics and the ``breakdown`` read.

The harness marks the host side with ``record_function`` ranges from
its own wrappers (``RANGES``); the sub-window itself is the range
``driftbench.subwindow``. Device activity is every kernel, copy and set
on the card (a range's own device-side span is not activity). Busy time
is the union of those intervals, not their sum. An idle gap is labelled
by the innermost range the host was in when the card went idle.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

SUBWINDOW = "driftbench.subwindow"
FLASH = "flash_attention"          # in the B4 kernel's symbol
STEP = "engine.step"
RANGES = (STEP, "api.prefill", "api.decode_step", "paged.prefill_chunk",
          "paged.decode_step", "sched.dispatch", "sched.complete",
          "harness.idle")


def start():
    """Start a profiler over the host's ops and the card's activity."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Labels:
    """Innermost host range at a time: the ranges (one thread, so
    nested) cut into segments, each with the range on top of the stack;
    looked up by bisection."""

    def __init__(self, ranges: List[Tuple[float, float, str]]):
        marks = sorted([(a, 1, -b, n) for a, b, n in ranges]
                       + [(b, 0, 0.0, n) for a, b, n in ranges])
        self.starts: List[float] = []
        self.names: List[str] = []
        stack: List[str] = []
        for t, opening, _, name in marks:
            if opening:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            self.starts.append(t)
            self.names.append(stack[-1] if stack else "harness")

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.names[i] if i >= 0 else "harness"


def reduce(events) -> Dict:
    """Summarise the profiler's ``events()`` (times in microseconds)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    window = None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not e.is_user_annotation:
                dev.append((a, b, e.name))
        elif e.name == SUBWINDOW:
            window = (a, b)
        elif e.name in RANGES:
            host.append((a, b, e.name))
    if window is None:
        raise RuntimeError("the profiled sub-window has no range")
    w0, w1 = window
    clipped = [(max(a, w0), min(b, w1), n) for a, b, n in dev
               if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in clipped])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for a, b, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((a - t, t))
        t = max(t, b)
    gaps.sort(reverse=True)
    labels = _Labels(host)
    idle_by: Dict[str, float] = {}
    for g, at in gaps:
        lab = labels.at(at)
        idle_by[lab] = idle_by.get(lab, 0.0) + g
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "device_ops": [[n[:120], us / 1e6] for n, us in top],
        "idle_gaps": [[labels.at(at), g / 1e6] for g, at in gaps[:10]],
        "idle_by_range": {k: v / 1e6 for k, v in sorted(
            idle_by.items(), key=lambda kv: -kv[1])},
        "flash_s": sum(b - a for a, b, n in clipped
                       if FLASH in n) / 1e6,
        "n_device_events": len(clipped),
    }
