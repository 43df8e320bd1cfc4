#!/usr/bin/env python3
"""The program's own spans in a traced run of a cell, read against the
device trace:

    python3 driftbench/spans.py --workload <cell> --seed <n> --seconds <s> \
        [--out FILE]

One traced window as ``run.py --trace 1`` runs it (the same harness,
wrappers and profiled sub-window), with the program's span recorder
(``repro_torch.obs.events.TraceRecorder``) installed before any engine
is built and taken out at the end. Prints one JSON line: the readings
below, the cell's per-layer metrics as ``run.py`` reads them, the check,
the fitted clock offset and its residual, idle time by innermost span,
and spans a step. The benchmark's runs do not run this, and no
``BENCHMARK.json`` metric reads it yet: the harness would have to
install the recorder and keep the profiler's events for its readers.

Reading the trace (``reduce``): a program span opened while the
profiler ran has a ``record_function`` range of its name on the host.
Idle time is labelled by the innermost range open (the harness's
``trace.RANGES`` and the program's spans together), integrated over
each idle interval. A device event belongs to the spans open when it
was *launched*: the CUDA runtime call with its correlation id (the
event's ``id``) gives the launch time. The program's spans are paired,
name by name and in order, with their ranges (names the harness also
ranges are left out), and one offset is fitted between their clocks.

The readings (``readings``), all over the window's steps outside the
sub-window or over the sub-window's trace:

* ``device.idle_share_in_prefill`` (%): sub-window time with nothing on
  the card while ``engine.prefill`` was open (innermost or around it);
* ``engine.prefill_ms_per_step``: mean summed ``engine.prefill`` spans a
  step;
* ``engine.first_token_hold_ms``: mean time from the end of a first
  token's ``engine.first_token`` span to the end of its step;
* ``kernels.attention_roofline`` (%): the B4 bound of the sub-window's
  ``ops.attention`` calls (``flops.flash_bound_s`` from each span's
  shape) over the device time of every kernel launched inside them,
  read only when every such call is causal self-attention;
* ``model.decode_launches``: device events launched inside
  ``model.decode`` spans, per span;
* ``core.busy_ms_per_step``: mean time a step in ``core.dispatch`` and
  ``core.complete`` spans.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse      # noqa: E402
import bisect        # noqa: E402
import gc            # noqa: E402
import json          # noqa: E402
import sys           # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from driftbench import trace  # noqa: E402
from driftbench.flops import flash_bound_s  # noqa: E402
from driftbench.record import percentile  # noqa: E402

# the program's span names start so (obs/events.py's SPAN_NAMES)
PROGRAM = ("engine.", "core.", "model.", "ops.", "kernels.")
PREFILL = "engine.prefill"
FIRST_TOKEN = "engine.first_token"
DECODE = "model.decode"
ATTENTION = "ops.attention"
CORE = ("core.dispatch", "core.complete")


def _is_runtime_call(e) -> bool:
    """A CUDA runtime or driver call on the host (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ``cuLaunchKernel``, ...): it carries the
    correlation id of the device event it issued."""
    return e.name.startswith("cu") and not e.is_user_annotation


class Stacks:
    """The host's open ranges at a time (one thread, so nested): the
    ranges cut into segments, each with its stack of names, innermost
    last; looked up by bisection."""

    def __init__(self, ranges: List[Tuple[float, float, str]]):
        marks = sorted([(a, 1, -b, n) for a, b, n in ranges]
                       + [(b, 0, 0.0, n) for a, b, n in ranges])
        self.starts: List[float] = []
        self.stacks: List[Tuple[str, ...]] = []
        stack: List[str] = []
        for t, opening, _, name in marks:
            if opening:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            self.starts.append(t)
            self.stacks.append(tuple(stack))

    def at(self, t: float) -> Tuple[str, ...]:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.stacks[i] if i >= 0 else ()

    def over(self, a: float, b: float):
        """The segments of ``[a, b)``: (length, stack) pairs."""
        i = bisect.bisect_right(self.starts, a) - 1
        t = a
        while t < b:
            nxt = self.starts[i + 1] if i + 1 < len(self.starts) else b
            end = min(nxt, b)
            if end > t:
                yield end - t, self.stacks[i] if i >= 0 else ()
                t = end
            i += 1


def label(stack: Tuple[str, ...]) -> str:
    return stack[-1] if stack else "harness"


def fit_offset(spans, ranges: List[Tuple[float, float, str]]) -> Dict:
    """Pair the program's ranged spans with their ``record_function``
    ranges, name by name in order of start (a name whose counts differ,
    or that the harness ranges too, is left out), and fit one offset
    (microseconds, trace clock minus ``t0_ns / 1e3``): the median of the
    differences. Returns the offset, the residual's p50, p99 and max
    (microseconds), the pairs (span, range) and the names left out."""
    by_name: Dict[str, List] = {}
    for sp in spans:
        if sp.ranged and sp.name not in trace.RANGES:
            by_name.setdefault(sp.name, []).append(sp)
    got: Dict[str, List] = {}
    for a, b, n in ranges:
        if n in by_name:
            got.setdefault(n, []).append((a, b, n))
    pairs, left_out = [], []
    for name, sps in by_name.items():
        rs = sorted(got.get(name, []))
        if len(rs) != len(sps):
            left_out.append(name)
            continue
        pairs += zip(sorted(sps, key=lambda s: s.t0_ns), rs)
    if not pairs:
        return {"offset_us": None, "pairs": [], "left_out": left_out}
    diffs = sorted(r[0] - sp.t0_ns / 1e3 for sp, r in pairs)
    off = diffs[len(diffs) // 2]
    res = [abs(d - off) for d in diffs]
    return {"offset_us": off, "residual_p50_us": percentile(res, 50),
            "residual_p99_us": percentile(res, 99),
            "residual_max_us": max(res), "n_pairs": len(pairs),
            "pairs": pairs, "left_out": sorted(left_out)}


def reduce(events, spans) -> Dict:
    """The profiler's ``events()`` (times in microseconds) with the
    recorder's spans: the sub-window's idle time by innermost span, the
    top idle gaps labelled so, each device event's launching stack (and
    the events and device seconds by innermost launching span), and the
    clock fit. Busy time is the union of device intervals, as
    ``trace.reduce`` takes it."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, launch = [], [], {}
    window = None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not e.is_user_annotation:
                dev.append((a, b, e.id, e.name))
        elif e.name == trace.SUBWINDOW:
            window = (a, b)
        elif e.name in trace.RANGES or e.name.startswith(PROGRAM):
            host.append((a, b, e.name))
        elif _is_runtime_call(e):
            launch.setdefault(e.id, a)
    if window is None:
        raise RuntimeError("the profiled sub-window has no range")
    w0, w1 = window
    stacks = Stacks(host)
    clipped = [(max(a, w0), min(b, w1)) for a, b, _, _ in dev
               if b > w0 and a < w1]
    busy = trace._union(clipped)
    idle, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    idle_by: Dict[str, float] = {}
    in_prefill = 0.0
    for a, b in idle:
        for length, stack in stacks.over(a, b):
            lab = label(stack)
            idle_by[lab] = idle_by.get(lab, 0.0) + length
            in_prefill += length if PREFILL in stack else 0.0
    gaps = sorted(((b - a, a) for a, b in idle), reverse=True)
    launched = []           # (device us, launching stack) in the window
    unlinked = 0
    for a, b, cid, _ in dev:
        t_launch = launch.get(cid)
        if t_launch is None:
            unlinked += b > w0 and a < w1
            continue
        if w0 <= t_launch < w1:
            launched.append((b - a, stacks.at(t_launch)))
    by_launcher: Dict[str, List[float]] = {}
    for us, stack in launched:
        n_us = by_launcher.setdefault(label(stack), [0, 0.0])
        n_us[0] += 1
        n_us[1] += us / 1e6
    fit = fit_offset(spans, host)
    windowed = [(sp, r) for sp, r in fit["pairs"]
                if w0 <= r[0] and r[1] <= w1]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "idle_by_span": {k: v / 1e6 for k, v in sorted(
            idle_by.items(), key=lambda kv: -kv[1])},
        "idle_in_prefill_s": in_prefill / 1e6,
        "idle_gaps": [[label(stacks.at(a)), g / 1e6,
                       " > ".join(stacks.at(a))] for g, a in gaps[:10]],
        "launched": launched,
        "launched_by_span": dict(sorted(by_launcher.items(),
                                        key=lambda kv: -kv[1][1])),
        "n_unlinked": unlinked,
        "n_decode": sum(1 for a, b, n in host
                        if n == DECODE and w0 <= a and b <= w1),
        "attention": [sp for sp, _ in windowed if sp.name == ATTENTION],
        "fit": {k: v for k, v in fit.items() if k != "pairs"},
    }


def _step_spans(run, spans) -> List[Tuple[object, Tuple]]:
    """The window engine's ``engine.step`` spans, each with its entry of
    ``run.steps`` (the warm-up engine's steps come first)."""
    steps = [sp for sp in spans if sp.name == "engine.step"]
    if len(steps) < len(run.steps):
        return []
    return list(zip(steps[len(steps) - len(run.steps):], run.steps))


def _in_window(run, step) -> bool:
    t0, t1, _, profiled = step
    return run.t_open <= t0 and t1 <= run.t_close and not profiled


def readings(run, spans, reduced: Optional[Dict]) -> Dict[str, float]:
    """The readings of the module doc (a reading with nothing to read is
    left out)."""
    out: Dict[str, float] = {}
    children: Dict[int, List] = {}
    for sp in spans:
        children.setdefault(sp.parent, []).append(sp)

    def below(sp):
        todo = list(children.get(sp.id, []))
        while todo:
            s = todo.pop()
            yield s
            todo += children.get(s.id, [])

    prefill, core, holds = [], [], []
    for sp, step in _step_spans(run, spans):
        if not _in_window(run, step):
            continue
        inner = list(below(sp))
        prefill.append(sum(s.dur_ns for s in inner if s.name == PREFILL))
        core.append(sum(s.dur_ns for s in inner if s.name in CORE))
        holds += [sp.t1_ns - s.t1_ns for s in inner if s.name == FIRST_TOKEN]
    if prefill:
        out["engine.prefill_ms_per_step"] = sum(prefill) / len(prefill) / 1e6
        out["core.busy_ms_per_step"] = sum(core) / len(core) / 1e6
    if holds:
        out["engine.first_token_hold_ms"] = sum(holds) / len(holds) / 1e6
    if not reduced:
        return out
    if reduced["window_s"] > 0:
        out["device.idle_share_in_prefill"] = \
            100.0 * reduced["idle_in_prefill_s"] / reduced["window_s"]
    if reduced["n_decode"]:
        out["model.decode_launches"] = sum(
            1 for _, st in reduced["launched"] if DECODE in st) \
            / reduced["n_decode"]
    attn_us = sum(us for us, st in reduced["launched"] if ATTENTION in st)
    # flash_bound_s counts a causal self-attention call: a window with
    # any other call has no bound here
    self_attn = all(sp.data["causal"] and sp.data["Lq"] == sp.data["Lk"]
                    for sp in reduced["attention"])
    if reduced["attention"] and self_attn and attn_us > 0:
        bound = 0.0
        for sp in reduced["attention"]:
            d = sp.data
            c = {"n_heads": d["H"], "n_kv_heads": d["Hk"], "head_dim": d["D"],
                 "sliding_window": d["window"]}
            bound += d["B"] * flash_bound_s(c, d["Lk"])
        out["kernels.attention_roofline"] = 100.0 * bound / (attn_us / 1e6)
    return out


def spans_per_step(run, spans) -> Optional[float]:
    """Spans recorded under the window engine's steps, per step."""
    pairs = _step_spans(run, spans)
    if not pairs:
        return None
    first = pairs[0][0].id
    return sum(1 for sp in spans if sp.id >= first) / len(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from driftbench import bench, check, harness
    from driftbench.run import power_limit
    from repro_torch import obs
    from repro_torch.obs.events import TraceRecorder

    man = bench.manifest()
    cell = bench.load_cell(args.workload, man=man)
    if not torch.cuda.is_available():
        harness.log("no CUDA card: this runs only on the card")
        return 2
    rec = obs.set_recorder(TraceRecorder())
    try:
        params = harness.draw_weights(cell, args.seed, "cuda")
        run = harness.run_window(cell, args.seed, args.seconds, True, "cuda",
                                 params, T_PROCESS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        events = run.prof.events()
        run.trace = trace.reduce(events)
        reduced = reduce(events, rec.spans())
        harness.log(f"trace: read in {time.perf_counter() - t:.1f} s")
    finally:
        obs.set_recorder(None)
    spans = rec.spans()
    run.prof = run.engine = events = None
    gc.collect()
    torch.cuda.empty_cache()
    ok, checks, details = check.verify(run, cell.reference, params,
                                       args.seed)
    harness.log(f"check: {details['sampled']} sampled, gaps "
                f"{details['gaps'][:5]}")
    per_layer = {}
    for m in bench.metrics_for(cell.name, True, man):
        v = bench.reader(m["name"])(run)
        if v is not None:
            per_layer[m["name"]] = v
    values = readings(run, spans, reduced)
    for k in ("launched", "attention"):
        reduced[f"n_{k}"] = len(reduced.pop(k))
    out = {"workload": cell.name, "seed": args.seed, "correct": ok,
           "card": torch.cuda.get_device_name(0),
           "power_limit": power_limit(), "readings": values,
           "per_layer": per_layer,
           "spans_per_step": spans_per_step(run, spans),
           "n_spans": len(spans), "trace": reduced,
           "checks": {k: v["value"] for k, v in checks.items()}}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
