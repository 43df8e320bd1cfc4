"""The port's host-clock spans (``obs/events.py``), on the CPU.

* The recorder: spans nest with their parents' ids and keep what the
  caller gave, are never sampled, are not events, and refuse an unknown
  name; the off recorder's span is one shared no-op that allocates
  nothing.
* A span opened inside a ``torch.profiler`` session opens a range of
  its name there (none outside one), on a clock one offset away.
* The engine, slot ring (dense and mamba2) and paged pool at smoke
  size, records the span tree of every step (``engine.*``, ``core.*``,
  ``model.*`` and the ``ops.*`` wrappers the two families reach), with
  the first token on the host before the decode starts, and the ``ops.*``
  spans in the engine's own recorder whatever the process-global one
  is; with the recorder on it emits the same tokens, stamps and
  completion order as with it off.
* A kernel's first-use build and load is one ``kernels.build`` span.
"""

import tracemalloc
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import smoke_config
from repro_torch.core.request import Category, Request, TenantTier
from repro_torch.core.scheduler import DriftScheduler
from repro_torch.kernels import _build
from repro_torch.models.registry import get_api
from repro_torch.obs import events as tr
from repro_torch.serving.engine import EngineConfig, ServingEngine


@pytest.fixture
def recorder():
    """A live recorder installed as the process-global one, then the
    no-op put back."""
    rec = obs.set_recorder(tr.TraceRecorder(sample_every={tr.DECODE_STEP: 1}))
    try:
        yield rec
    finally:
        obs.set_recorder(None)


def test_spans_nest_with_parent_ids_and_data():
    rec = tr.TraceRecorder()
    with rec.span(tr.ENGINE_STEP) as step:
        with rec.span(tr.ENGINE_ADMIT) as admit:
            with rec.span(tr.CORE_DISPATCH):
                pass
        with rec.span(tr.ENGINE_PREFILL, B=1, Lk=32):
            pass
    with rec.span(tr.ENGINE_STEP):
        pass
    spans = rec.spans()
    assert [s.name for s in spans] == [tr.ENGINE_STEP, tr.ENGINE_ADMIT,
                                       tr.CORE_DISPATCH, tr.ENGINE_PREFILL,
                                       tr.ENGINE_STEP]
    first, adm, disp, pre, second = spans
    assert first is step and adm is admit
    assert first.parent is None and second.parent is None
    assert adm.parent == first.id and pre.parent == first.id
    assert disp.parent == adm.id
    assert pre.data == {"B": 1, "Lk": 32}
    assert adm.data == disp.data == {}
    assert len({s.id for s in spans}) == 5
    for s in spans:
        assert 0 < s.t0_ns <= s.t1_ns and not s.ranged
    assert first.t0_ns <= adm.t0_ns <= disp.t0_ns <= disp.t1_ns \
        <= adm.t1_ns <= pre.t0_ns <= pre.t1_ns <= first.t1_ns
    assert rec.stats()["emitted"] == 0        # spans are not events
    with pytest.raises(ValueError, match="unknown span"):
        rec.span("engine.nap")


def test_null_recorder_span_is_a_shared_noop_that_allocates_nothing():
    null = tr.NULL_RECORDER
    assert null.span(tr.ENGINE_STEP) is null.span(tr.OPS_ATTENTION, B=1) \
        is tr.NULL_SPAN
    assert null.spans() == []
    with null.span(tr.ENGINE_STEP) as s:
        assert s is tr.NULL_SPAN
    assert not hasattr(tr.NULL_SPAN, "__dict__")
    span = null.span

    def spin(n):
        for _ in range(n):
            with span(tr.ENGINE_STEP):
                pass

    spin(100)
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        spin(10_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after == before and peak - before < 1024


def test_spans_are_never_sampled_and_observers_see_only_events():
    class Seen:
        def __init__(self):
            self.events = []

        def on_event(self, ev):
            self.events.append(ev.kind)

    seen, late = Seen(), Seen()
    rec = tr.TraceRecorder(capacity=1000, observers=[seen])
    rec.add_observer(late)
    for i in range(64):
        rec.emit(float(i), tr.DECODE_STEP, req_id=1)
        with rec.span(tr.MODEL_DECODE):
            pass
    assert len(rec.events()) == 2                  # decode_step 1:32
    assert len(rec.spans()) == 64
    assert seen.events == late.events == [tr.DECODE_STEP] * 64


def test_spans_mirror_into_a_profiler_session_and_only_there():
    rec = tr.TraceRecorder()

    def work():
        with rec.span(tr.ENGINE_STEP):
            with rec.span(tr.MODEL_DECODE):
                torch.ones(64).sum()
            with rec.span(tr.ENGINE_SAMPLE):
                torch.zeros(8).argmax()

    def session():
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        for _ in range(20):
            work()
        prof.stop()
        return prof

    # a process's first range costs ~1 ms more to open: not a clock offset
    session()
    rec = tr.TraceRecorder()
    work()
    prof = session()
    work()
    spans = rec.spans()
    assert [s.ranged for s in spans] == [False] * 3 + [True] * 60 \
        + [False] * 3
    names = {tr.ENGINE_STEP, tr.MODEL_DECODE, tr.ENGINE_SAMPLE}
    ranges = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name in names)
    ranged = sorted((s for s in spans if s.ranged), key=lambda s: s.t0_ns)
    assert [n for _, n in ranges] == [s.name for s in ranged]
    diffs = sorted(us - s.t0_ns / 1e3 for (us, _), s in zip(ranges, ranged))
    off = diffs[len(diffs) // 2]
    assert max(abs(d - off) for d in diffs) < 1000.0     # microseconds


def _requests(n=4):
    return [Request(tenant=TenantTier.STANDARD, category=Category.SHORT_QA,
                    prompt="tell me about spans " * (i + 1),
                    prompt_tokens=5 + 9 * i, max_tokens=16,
                    true_output_tokens=2 + 2 * i) for i in range(n)]


ARMS = {
    "dense-slot": ("h2o-danube-1.8b", dict(paged=False)),
    "mamba2-slot": ("mamba2-2.7b", dict(paged=False)),
    "dense-paged": ("h2o-danube-1.8b", dict(paged=True,
                                            chunk_prefill_tokens=8)),
}
# the ops each arm's model calls reach (the paged pool's chunked prefill
# and paged decode kernels have no span)
OPS = {"dense-slot": (tr.OPS_ATTENTION, tr.OPS_DECODE_ATTENTION),
       "mamba2-slot": (tr.OPS_SSD_WITH_STATE, tr.OPS_SSM_DECODE_STEP),
       "dense-paged": (None, None)}
_PARAMS = {}


def _serve(arm, traced, explicit=False):
    """Drain four requests through a smoke engine; returns the engine,
    the requests, each step's last tokens and the recorder (None when
    off). ``explicit`` hands the recorder to the engine, with another
    live recorder as the process-global one, which gets no span and is
    the global one again after each step."""
    arch, kw = ARMS[arm]
    cfg = smoke_config(arch).replace(dtype="float32")
    if arch not in _PARAMS:
        _PARAMS[arch] = get_api(cfg).init(
            cfg, torch.Generator().manual_seed(0), device="cpu")
    rec = tr.TraceRecorder(sample_every={tr.DECODE_STEP: 1}) \
        if traced else None
    outer = obs.set_recorder(tr.TraceRecorder() if explicit else rec)
    try:
        sched = DriftScheduler("sjf")
        engine = ServingEngine(cfg, _PARAMS[arch], sched,
                               EngineConfig(n_slots=2, max_len=96, **kw),
                               device="cpu", trace=rec if explicit else None)
        reqs = _requests()
        for r in reqs:
            sched.submit(r, 0.0)
        lasts, now = [], 0.0
        while sched.queue_depth() or engine.active_slots():
            engine.step(now)
            assert obs.get_recorder() is outer
            lasts.append([s.last_token for s in engine.slots])
            now += 1.0
        assert not explicit or outer.spans() == []
    finally:
        obs.set_recorder(None)
    return engine, reqs, lasts, rec


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_records_the_span_tree_every_step(arm, explicit):
    engine, reqs, lasts, rec = _serve(arm, traced=True, explicit=explicit)
    assert obs.get_recorder() is tr.NULL_RECORDER
    spans = rec.spans()
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
        if s.parent is not None:
            parent = next(p for p in spans if p.id == s.parent)
            assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns

    def names(s):
        return [c.name for c in kids.get(s.id, [])]

    steps = kids[None]
    assert [s.name for s in steps] == [tr.ENGINE_STEP] * len(lasts)
    paged = engine.ecfg.paged
    prefill_op, decode_op = OPS[arm]
    admitted = firsts = retired = 0
    for step in steps:
        top = names(step)
        assert set(top) <= {tr.ENGINE_ADMIT, tr.ENGINE_PREFILL,
                            tr.ENGINE_DECODE}
        decode = [c for c in kids.get(step.id, [])
                  if c.name == tr.ENGINE_DECODE]
        for c in kids.get(step.id, []):
            if c.name == tr.ENGINE_ADMIT:
                assert names(c) == [tr.CORE_DISPATCH]
                admitted += 1
            if c.name == tr.ENGINE_PREFILL:
                inner = names(c)
                assert inner[0] == tr.MODEL_PREFILL
                assert (tr.ENGINE_INSERT_CACHE in inner) == (not paged)
                model = kids[c.id][0]
                assert set(names(model)) == ({prefill_op} - {None})
                for ft in kids[c.id]:
                    if ft.name == tr.ENGINE_FIRST_TOKEN:
                        firsts += 1
                        # the first token is on the host before the
                        # step's decode starts
                        assert all(ft.t1_ns <= d.t0_ns for d in decode)
        assert len(decode) <= 1
        for d in decode:
            inner = names(d)
            assert inner[:2] == [tr.MODEL_DECODE, tr.ENGINE_SAMPLE]
            assert set(inner[2:]) <= {tr.ENGINE_RETIRE}
            assert set(names(kids[d.id][0])) == ({decode_op} - {None})
            for ret in kids[d.id][2:]:
                assert names(ret) == [tr.CORE_COMPLETE]
                retired += 1
    assert admitted == firsts == retired == len(reqs)
    for s in spans:
        if s.name == tr.OPS_ATTENTION:
            assert s.data == dict(
                B=1, Lq=s.data["Lk"], Lk=s.data["Lk"], H=engine.cfg.n_heads,
                Hk=engine.cfg.n_kv_heads, D=engine.cfg.head_dim, causal=True,
                window=engine.cfg.sliding_window)
            assert s.data["Lk"] in engine.ecfg.prompt_buckets
        else:
            assert s.data == {}
    ids = sorted(r.req_id for r in reqs)
    kinds = [(e.kind, e.req_id) for e in rec.events()]
    for rid in ids:
        assert kinds.count((tr.FIRST_TOKEN, rid)) == 1
        assert kinds.count((tr.COMPLETE, rid)) == 1


@pytest.mark.parametrize("arm", list(ARMS))
def test_recorder_on_serves_the_same_tokens_stamps_and_order(arm):
    e_off, r_off, lasts_off, _ = _serve(arm, traced=False)
    e_on, r_on, lasts_on, rec = _serve(arm, traced=True)
    assert rec.spans() and rec.events()
    assert lasts_on == lasts_off
    assert [r.prompt for r in e_on.sched.completed] \
        == [r.prompt for r in e_off.sched.completed]
    for a, b in zip(r_off, r_on):
        assert (a.dispatch_time, a.prefill_end, a.completion_time,
                a.cached_prompt_tokens) == (b.dispatch_time, b.prefill_end,
                                            b.completion_time,
                                            b.cached_prompt_tokens)
    for k in ("step_count", "busy_steps", "n_prefill_launches",
              "n_decode_launches", "prefill_chunk_log"):
        assert getattr(e_on, k) == getattr(e_off, k), k


def test_a_kernel_build_is_one_span_and_a_loaded_kernel_none(recorder,
                                                            monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_start", lambda name: calls.append(name))
    monkeypatch.setattr(_build, "_finish", lambda name, started: "")
    lib = SimpleNamespace(flash_attention_launch=SimpleNamespace())
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
    for _ in range(3):
        fn = _build.load("flash_attention", "flash_attention_launch")
    assert fn is lib.flash_attention_launch and calls == ["flash_attention"]
    spans = recorder.spans()
    assert [(s.name, s.data) for s in spans] == [(tr.KERNELS_BUILD, {})]
