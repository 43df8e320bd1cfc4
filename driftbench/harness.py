"""Drive the program as a tenant-facing service does: open-loop
arrivals through ``DriftScheduler.submit(req, now)`` and
``ServingEngine.step(now)`` in a loop on one thread, ``now`` being the
harness's monotonic clock.

A request due during a step is submitted after that step, with ``now``
its due time; how late that was is logged. A token is stamped when the
``step`` that produced it returns, which is when it exists on the host
(each step ends in a device-to-host copy of the sampled tokens).

The benchmark sees the program's output through wrappers it installs
on the engine it built (``Tap``): the first token as the engine hands
it to ``_emit_first_token``, each decode step's tokens as
``sample_logits`` returns them (on either engine cache), and the
scheduler's submits, dispatches and completions. In a traced run the
same wrappers open ``record_function`` ranges and time the model's
calls, synchronised. The engine's counters are read at the window's
open and close.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List

import torch

from . import trace
from .bench import Cell
from .gen import traffic as gen
from .record import Call, ReqLog, Run
from .reference import tokens as toks

_TIERS = {"premium": "PREMIUM", "standard": "STANDARD", "batch": "BATCH"}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def model_config(cell: Cell):
    """The program's ``ModelConfig`` as the configuration file states
    it: the registry entry with every size of the file laid over it."""
    from repro_torch.configs import get_config
    base = get_config(cell.config["registry"])
    return base.replace(**cell.config["model"])


def draw_weights(cell: Cell, seed: int, device: str):
    """The weights, drawn by the benchmark from the seed on ``device``
    in the port's leaf layout (the reference family's ``draw``)."""
    gen_ = torch.Generator(device=device).manual_seed(int(seed))
    return cell.reference.draw(cell.sizes, gen_)


def make_request(rec: gen.Record):
    from repro_torch.core.request import Category, Request, TenantTier
    return Request(tenant=TenantTier[_TIERS[rec.tenant]],
                   category=Category(rec.category), prompt=rec.prompt,
                   prompt_tokens=rec.prompt_tokens,
                   max_tokens=rec.max_tokens,
                   true_output_tokens=rec.true_output_tokens,
                   prefix_group=rec.prefix_group,
                   shared_prefix_tokens=rec.shared_prefix_tokens)


def make_engine(cell: Cell, cfg, params, device: str):
    from repro_torch.core.estimator import DriftConfig
    from repro_torch.core.scheduler import DriftScheduler
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    spec = cell.spec
    ecfg = dict(spec["engine"])
    ecfg["prompt_buckets"] = tuple(ecfg["prompt_buckets"])
    sched = DriftScheduler(spec["policy"], config=DriftConfig())
    return ServingEngine(cfg, params, sched, EngineConfig(**ecfg),
                         device=device)


class Tap:
    """The benchmark's wrappers on one engine (see the module doc).

    Tokens are taken where every engine path meets: a first token as
    the engine hands it to ``_emit_first_token``, and a decode step's
    tokens as ``sample_logits`` returns them, with the lanes that were
    decoding then (a sample that a first token claims next was that
    prefill's). The traced model calls are the slot ring's
    ``api.prefill`` / ``api.decode_step`` and the paged pool's
    ``transformer.prefill_chunk_paged`` / ``decode_step_paged``; each
    is timed with the FLOPs of its live tokens (the configuration's
    ``reference/<family>.py`` counts them)."""

    def __init__(self, engine, cell: Cell, run_reqs: Dict[int, ReqLog],
                 clock, traced: bool):
        import repro_torch.serving.engine as engine_mod
        self.reqs, self.clock = run_reqs, clock
        self.first: List = []
        self.sampled = None              # (tokens, lanes) not yet claimed
        self.log: List = []              # scheduler events, in order
        self.prefills: List[Call] = []
        self.decodes: List[Call] = []
        self.profiling = False
        self._patched: List = []         # (module, name, original)
        fam, sizes = cell.reference, cell.sizes
        prefix = engine.prefix_tree is not None
        api = engine.api
        emit = engine._emit_first_token
        sched = engine.sched
        dispatch, complete = sched.dispatch, sched.complete

        def ranged(name, fn):
            if not traced:
                return fn
            from torch.profiler import record_function

            def wrapped(*a, **k):
                with record_function(name):
                    return fn(*a, **k)
            return wrapped

        def patch(module, name, wrapper):
            self._patched.append((module, name, getattr(module, name)))
            setattr(module, name, wrapper)

        def decoding():
            return [(i, s.req.req_id) for i, s in enumerate(engine.slots)
                    if s.req is not None and not s.pending_prefill]

        def timed(calls, fn, flop, bucket, *a, **kw):
            t0 = self.clock()
            out = fn(*a, **kw)
            _sync(engine.device)
            calls.append(Call(t0, self.clock(), flop, self.profiling, bucket))
            return out

        def prompt_flops(st, start, end):
            """The live prompt tokens at bucket positions [start, end)."""
            r = self.reqs[st.req.req_id]
            lo, hi = toks.live_span(r.rec, r.bucket, prefix)
            a, b = (min(max(x, lo), hi) - lo for x in (start, end))
            return r.bucket, fam.prefill_flops(sizes, b) \
                - fam.prefill_flops(sizes, a)

        def decode_flops():
            f = 0.0
            for _, rid in decoding():
                r = self.reqs[rid]
                n = toks.prompt_len(r.rec.prompt_tokens, r.bucket)
                f += fam.token_flops(sizes, n + len(r.tokens))
            return f

        def on_first(slot, tok, now):
            self.sampled = None
            self.first.append((engine.slots[slot].req.req_id, tok))
            return emit(slot, tok, now)

        def on_sample(logits, g, temperature):
            out = sample(logits, g, temperature)
            self.sampled = (out, decoding())
            return out

        def on_prefill(cfg, params, batch, **kw):
            st = next(s for s in engine.slots if s.batch is batch)
            bucket, f = prompt_flops(st, 0, st.bucket)
            return timed(self.prefills, prefill, f, bucket, cfg, params,
                         batch, **kw)

        def on_chunk(cfg, params, pool, tokens, *a, **kw):
            ptr = tokens.untyped_storage().data_ptr()
            st = next(s for s in engine.slots if s.batch is not None
                      and s.batch["tokens"].untyped_storage().data_ptr()
                      == ptr)
            bucket, f = prompt_flops(st, st.prefill_pos,
                                     st.prefill_pos + tokens.shape[-1])
            return timed(self.prefills, chunk, f, bucket, cfg, params, pool,
                         tokens, *a, **kw)

        def decode_call(fn):
            return lambda *a, **kw: timed(self.decodes, fn, decode_flops(),
                                          0, *a, **kw)

        def on_dispatch(now):
            req = dispatch(now)
            if req is not None:
                self.log.append(("dispatch", req.req_id))
            return req

        def on_complete(req, observed, now, phase=None):
            self.log.append(("complete", req.req_id, int(observed)))
            return complete(req, observed, now, phase)

        sample = engine_mod.sample_logits
        patch(engine_mod, "sample_logits", on_sample)
        engine._emit_first_token = on_first
        sched.dispatch = ranged("sched.dispatch", on_dispatch)
        sched.complete = ranged("sched.complete", on_complete)
        self.step = ranged(trace.STEP, engine.step)
        if traced:
            from repro_torch.models import transformer
            prefill, chunk = api.prefill, transformer.prefill_chunk_paged
            engine.api = dataclasses.replace(
                api, prefill=ranged("api.prefill", on_prefill),
                decode_step=ranged("api.decode_step",
                                   decode_call(api.decode_step)))
            patch(transformer, "prefill_chunk_paged",
                  ranged("paged.prefill_chunk", on_chunk))
            patch(transformer, "decode_step_paged",
                  ranged("paged.decode_step",
                         decode_call(transformer.decode_step_paged)))

    def close(self) -> None:
        for module, name, orig in reversed(self._patched):
            setattr(module, name, orig)
        self._patched = []

    def flush(self, t: float) -> int:
        """Stamp this step's tokens at ``t``; returns how many."""
        n = 0
        for rid, tok in self.first:
            r = self.reqs[rid]
            r.tokens.append(int(tok))
            r.stamps.append(t)
            n += 1
        if self.sampled is not None:
            out, lanes = self.sampled
            host = out.cpu().tolist()
            for i, rid in lanes:
                r = self.reqs[rid]
                r.tokens.append(int(host[i]))
                r.stamps.append(t)
                n += 1
        self.first, self.sampled = [], None
        return n


def counters(engine) -> Dict[str, float]:
    """The engine's and the scheduler's own counters (every plain
    number on them), for a reader of a program counter: taken at the
    window's open and close."""
    out = {}
    for prefix, obj in (("engine", engine), ("sched", engine.sched)):
        for k, v in vars(obj).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f"{prefix}.{k}"] = float(v)
    return out


def warm_up(cell: Cell, cfg, params, device: str, buckets) -> None:
    """Run every prompt bucket the traffic uses once, and decode steps,
    on a throwaway engine: builds the kernels and sets up every shape
    the window will see."""
    engine = make_engine(cell, cfg, params, device)
    for b in sorted(buckets):
        rec = gen.Record(due=0.0, tenant="standard", category="short_qa",
                         prompt="warm up " * b, prompt_tokens=b,
                         max_tokens=4, true_output_tokens=4)
        engine.sched.submit(make_request(rec), 0.0)
    while engine.sched.queue_depth() or engine.active_slots():
        engine.step(0.0)
    _sync(torch.device(device))
    del engine
    gc.collect()


def run_window(cell: Cell, seed: int, seconds: float, traced: bool,
               device: str, params, t_process: float,
               clock=time.perf_counter, sleep=time.sleep) -> Run:
    """Set up the engine, run the warm-up traffic and the window, and
    return what it recorded. ``t_process`` is the process's start on
    ``clock`` (set-up is counted from it); a test passes a clock and a
    sleep of its own, so that a window holds the same work on any
    machine."""
    spec = cell.spec
    warm_s = float(spec["warm_s"])
    rate = float(spec["rate_per_s"])
    ecfg = spec["engine"]
    buckets = ecfg["prompt_buckets"]
    records = gen.plan(cell.traffic, rate, warm_s + seconds, seed)
    log("plan:", gen.summary(records), "rate", rate, "warm_s", warm_s)
    used = {toks.bucket_for(r.prompt_tokens, buckets) for r in records}
    cfg = model_config(cell)
    warm_up(cell, cfg, params, device, used)
    engine = make_engine(cell, cfg, params, device)
    if traced:
        from torch.profiler import record_function
        prof = trace.start()              # pay the profiler's first start
        torch.zeros(1, device=device).add_(1)
        prof.stop()
    reqs: Dict[int, ReqLog] = {}
    t0 = clock()
    since = lambda: clock() - t0                                 # noqa: E731
    tap = Tap(engine, cell, reqs, since, traced)
    steps = []
    late = []
    t_open, t_close = warm_s, warm_s + seconds
    # the profiled sub-window ends the window (stopping the profiler
    # stalls the host for seconds, which would hold up the steps after
    # it); the cell may set its length, e.g. to one whole burst period
    p0 = t_close - min(float(spec.get("trace_s", 2.0)), 0.5 * seconds)
    prof = rng = None
    i, n = 0, len(records)
    setup_s = at_open = None
    try:
        while True:
            now = since()
            while i < n and records[i].due <= now:
                rec = records[i]
                req = make_request(rec)
                b = toks.bucket_for(rec.prompt_tokens, buckets)
                reqs[req.req_id] = ReqLog(rec, req, b, toks.target(
                    rec.true_output_tokens, rec.max_tokens, ecfg["max_len"], b))
                engine.sched.submit(req, rec.due)
                tap.log.append(("submit", req.req_id))
                late.append(since() - rec.due)
                i += 1
            if setup_s is None and now >= t_open:
                setup_s = clock() - t_process
                at_open = counters(engine)
            if now >= t_close:
                break
            if traced and prof is None and now >= p0:
                prof = trace.start()
                rng = record_function(trace.SUBWINDOW)
                rng.__enter__()
                tap.profiling = True
            if engine.sched.queue_depth() == 0 and not engine.active_slots():
                nxt = min(records[i].due if i < n else t_close, t_close)
                if traced:
                    nxt = min(nxt, p0) if p0 > now else nxt
                    with record_function("harness.idle"):
                        sleep(max(0.0, nxt - now))
                else:
                    sleep(max(0.0, nxt - now))
                continue
            tap.step(now)
            t = since()
            steps.append((now, t, tap.flush(t), tap.profiling))
        at_close = counters(engine)
        if tap.profiling:
            rng.__exit__(None, None, None)
            prof.stop()
            tap.profiling = False
    finally:
        tap.close()
    late.sort()
    log("generator late s: p50", late[len(late) // 2] if late else None,
        "max", late[-1] if late else None, "submitted", i, "of", n)
    for name, calls in (("prefill", tap.prefills), ("decode", tap.decodes)):
        if calls:
            log(f"{name}: {len(calls)} calls, mean "
                f"{1e3 * sum(c.t1 - c.t0 for c in calls) / len(calls):.2f} ms")
    run = Run(cell=cell, seed=seed, t_open=t_open, t_close=t_close,
              setup_s=setup_s, reqs=reqs, steps=steps,
              prefills=tap.prefills, decodes=tap.decodes,
              sched_log=tap.log, counters=(at_open, at_close),
              engine=engine, prof=prof)
    return run
