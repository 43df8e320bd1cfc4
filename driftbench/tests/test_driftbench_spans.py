"""``spans.py``: the program's spans read against the device trace.

On a synthetic trace whose answers are counted by hand: a device event
belongs to the spans open when its runtime call launched it (joined by
correlation id), not to those open while it ran; idle time is split by
the innermost open range, harness or program, and the share of it inside
``engine.prefill`` is at most the idle share; the readings over a
synthetic run; the clock fit. On the CPU at a smoke size: a traced
window with the program's recorder on gives the accepted readers the
same values as with it off, and its spans sit on the profiler's clock.
"""

import random
from types import SimpleNamespace

import pytest
import torch

from driftbench import bench, harness, spans, trace
from driftbench.flops import flash_bound_s
from driftbench.record import Run
from driftbench.tests.test_driftbench_faults import (FAMILIES, StepClock,
                                                     smoke_cell)

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
OFFSET_US = -5000.0       # trace clock minus the program's, microseconds
SHAPE = dict(B=1, Lq=64, Lk=64, H=32, Hk=8, D=80, causal=True, window=4096)

# (name, start us, end us, data, harness range inside it); nested by time
PROGRAM = [
    ("engine.step", 12, 898, {}, None),
    ("engine.prefill", 20, 400, {}, None),
    ("model.prefill", 30, 300, {}, "api.prefill"),
    ("ops.attention", 50, 100, SHAPE, None),
    ("ops.attention", 150, 200, SHAPE, None),
    ("engine.first_token", 310, 390, {}, None),
    ("engine.decode", 410, 880, {}, None),
    ("model.decode", 420, 700, {}, "api.decode_step"),
    ("ops.decode_attention", 430, 460, {}, None),
    ("engine.sample", 710, 800, {}, None),
]
# (correlation id, launch us, device start, device end); 107 has no
# runtime call in the trace
DEVICE = [(101, 55, 60, 90), (102, 160, 165, 195), (103, 250, 255, 280),
          (104, 440, 445, 471), (105, 690, 705, 760), (106, 720, 765, 770),
          (107, None, 990, 995)]


def _ev(name, a, b, eid=0, device=CPU, annotation=False):
    return SimpleNamespace(name=name, id=eid, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=a, end=b))


def _span(i, name, a, b, data, parent):
    return SimpleNamespace(name=name, id=i, parent=parent, ranged=True,
                           t0_ns=int((a - OFFSET_US) * 1e3),
                           t1_ns=int((b - OFFSET_US) * 1e3), data=data,
                           dur_ns=int((b - a) * 1e3))


def synthetic(program=True):
    """The trace's events and the program's spans (none when
    ``program`` is false: the harness's ranges and the device alone)."""
    events = [_ev(trace.SUBWINDOW, 0, 1000, annotation=True),
              _ev("engine.step", 10, 900, annotation=True)]
    sp = []
    for name, a, b, data, inner in PROGRAM:
        if inner:
            events.append(_ev(inner, a + 2, b - 2, annotation=True))
        if not program:
            continue
        events.append(_ev(name, a, b, annotation=True))
        parent = next((s.id for s in reversed(sp)
                       if s.t0_ns <= (a - OFFSET_US) * 1e3 < s.t1_ns), None)
        sp.append(_span(len(sp), name, a, b, data, parent))
    for cid, launch, a, b in DEVICE:
        if launch is not None:
            events.append(_ev("cudaLaunchKernel", launch, launch + 3, cid))
        name = "flash_attention_bf16_kernel" if cid in (101, 102) \
            else "elementwise_kernel"
        events.append(_ev(name, a, b, cid, device=CUDA))
        events.append(_ev(name, a, b, cid, device=CUDA, annotation=True))
    random.Random(0).shuffle(events)
    return events, sp


def test_device_events_belong_to_the_spans_that_launched_them():
    events, sp = synthetic()
    red = spans.reduce(events, sp)
    by_us = {us: st for us, st in red["launched"]}
    assert len(red["launched"]) == 6 and red["n_unlinked"] == 1
    assert by_us[30][-1] == "ops.attention"       # 101, 102
    assert by_us[25][-2:] == ("model.prefill", "api.prefill")
    assert by_us[26][-2:] == ("api.decode_step", "ops.decode_attention")
    # launched inside model.decode, ran after it closed
    assert "model.decode" in by_us[55]
    assert by_us[5][-1] == "engine.sample"
    assert red["n_decode"] == 1 and len(red["attention"]) == 2
    read = spans.readings(SimpleNamespace(steps=[]), sp, red)
    assert read["model.decode_launches"] == 2.0
    bound = 2 * flash_bound_s({"n_heads": 32, "n_kv_heads": 8,
                               "head_dim": 80, "sliding_window": 4096}, 64)
    assert read["kernels.attention_roofline"] == pytest.approx(
        100.0 * bound / 60e-6)


def test_idle_is_split_by_innermost_span_and_prefill_within_it():
    events, sp = synthetic()
    red = spans.reduce(events, sp)
    # idle: [0,60) [90,165) [195,255) [280,445) [471,705) [760,765)
    # [770,990) [995,1000)
    assert red["window_s"] == pytest.approx(1e-3)
    assert red["busy_s"] == pytest.approx(176e-6)
    assert sum(red["idle_by_span"].values()) == pytest.approx(824e-6)
    # [20,60) [90,165) [195,255) [280,400): engine.prefill open
    assert red["idle_in_prefill_s"] == pytest.approx(295e-6)
    by = red["idle_by_span"]
    # [50,60) [90,100) [150,165) [195,200)
    assert by["ops.attention"] == pytest.approx(40e-6)
    assert by["engine.first_token"] == pytest.approx(80e-6)
    # [0,10) [900,990) [995,1000): no range open
    assert by["harness"] == pytest.approx(105e-6)
    assert red["idle_gaps"][0][:2] == ["api.decode_step",
                                       pytest.approx(234e-6)]
    assert red["idle_gaps"][0][2].endswith("model.decode > api.decode_step")
    read = spans.readings(SimpleNamespace(steps=[]), sp, red)
    assert read["device.idle_share_in_prefill"] == pytest.approx(29.5)
    rng = random.Random(3)
    for _ in range(20):
        evs, s = synthetic()
        for _ in range(6):
            a = rng.uniform(0, 990)
            evs.append(_ev("k", a, a + rng.uniform(1, 50), 0, device=CUDA))
        r = spans.reduce(evs, s)
        idle = 100.0 * (1 - r["busy_s"] / r["window_s"])
        share = spans.readings(SimpleNamespace(steps=[]), s, r)[
            "device.idle_share_in_prefill"]
        assert 0 < share <= idle


@pytest.mark.parametrize("odd", [dict(causal=False), dict(Lq=1)])
def test_the_attention_roofline_needs_causal_self_attention(odd):
    """``flash_bound_s`` counts a causal self-attention call: a window
    with another kind of ``ops.attention`` call reads no roofline."""
    events, sp = synthetic()
    sp[4].data = dict(SHAPE, **odd)
    red = spans.reduce(events, sp)
    read = spans.readings(SimpleNamespace(steps=[]), sp, red)
    assert "kernels.attention_roofline" not in read
    assert read["model.decode_launches"] == 2.0


def test_program_spans_leave_trace_reduce_as_it_was():
    with_spans, _ = synthetic(program=True)
    without, _ = synthetic(program=False)
    assert trace.reduce(with_spans) == trace.reduce(without)


def test_the_clock_fit_pairs_spans_with_their_ranges():
    events, sp = synthetic()
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.is_user_annotation and e.device_type == CPU]
    fit = spans.fit_offset(sp, ranges)
    # engine.step is ranged by the harness too: left out of the pairs
    assert fit["n_pairs"] == len(PROGRAM) - 1
    assert fit["offset_us"] == pytest.approx(OFFSET_US)
    assert fit["residual_max_us"] == pytest.approx(0.0, abs=1e-3)
    fit = spans.fit_offset([s for s in sp if s.id != 4], ranges)
    assert fit["left_out"] == ["ops.attention"]


def test_span_readings_over_the_window_steps():
    """Three steps of the window engine after one of the warm-up's: the
    profiled step and the warm-up step are not read."""
    ms = 1_000_000

    def sp(i, name, a, b, parent):
        return SimpleNamespace(name=name, id=i, parent=parent, t0_ns=a * ms,
                               t1_ns=b * ms, dur_ns=(b - a) * ms,
                               data={}, ranged=False)

    tree = [sp(0, "engine.step", 0, 100, None),            # warm-up
            sp(1, "engine.prefill", 0, 90, 0),
            sp(2, "engine.step", 200, 300, None),
            sp(3, "engine.admit", 200, 205, 2),
            sp(4, "core.dispatch", 201, 203, 3),
            sp(5, "engine.prefill", 205, 245, 2),
            sp(6, "engine.first_token", 240, 244, 5),
            sp(7, "engine.prefill", 245, 265, 2),
            sp(8, "engine.first_token", 260, 262, 7),
            sp(9, "engine.decode", 265, 300, 2),
            sp(10, "engine.retire", 290, 296, 9),
            sp(11, "core.complete", 291, 295, 10),
            sp(12, "engine.step", 300, 400, None),
            sp(13, "engine.decode", 300, 400, 12),
            sp(14, "engine.step", 400, 500, None),           # profiled
            sp(15, "engine.prefill", 400, 480, 14)]
    run = Run(cell=None, seed=0, t_open=1.0, t_close=5.0, setup_s=1.0,
              reqs={}, steps=[(1.0, 1.1, 3, False), (1.1, 1.2, 1, False),
                              (4.9, 5.0, 1, True)])
    read = spans.readings(run, tree, None)
    assert read == {"engine.prefill_ms_per_step": pytest.approx(30.0),
                    "core.busy_ms_per_step": pytest.approx(3.0),
                    "engine.first_token_hold_ms": pytest.approx(47.0)}
    assert spans.spans_per_step(run, tree) == pytest.approx(14 / 3)


# the per-layer readers the benchmark had before the program's spans
ACCEPTED = (
    "core.estimate_mae_tokens", "core.queue_wait_p95_ms",
    "device.idle_share", "device.idle_share.bursty",
    "device.idle_share.flood", "device.window_mfu",
    "engine.iteration_ms", "engine.iteration_ms.bursty",
    "engine.tokens_per_iteration", "itl_mean_ms", "itl_mean_ms.bursty",
    "itl_p95_ms", "kernels.flash_attention_roofline",
    "model.decode_mfu", "model.decode_mfu.bursty", "model.decode_mfu.flood",
    "model.prefill_mfu", "model.prefill_mfu.bursty", "output_tokens_per_s",
    "setup_s", "ttft_mean_ms", "ttft_p95_ms",
)


def _window(cell, traced_spans, seed=5):
    from repro_torch import obs
    from repro_torch.obs.events import TraceRecorder
    params = harness.draw_weights(cell, seed, "cpu")
    clock = StepClock()
    rec = obs.set_recorder(TraceRecorder() if traced_spans else None)
    try:
        run = harness.run_window(cell, seed, 2.0, True, "cpu", params, 0.0,
                                 clock=clock, sleep=clock.sleep)
    finally:
        obs.set_recorder(None)
    events = run.prof.events()
    run.trace = trace.reduce(events)
    run.engine = run.prof = None
    return run, rec, events


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_the_recorder_changes_no_accepted_reading(family):
    cell = smoke_cell(*FAMILIES[family])
    off, _, _ = _window(cell, False)
    on, rec, events = _window(cell, True)
    for name in ACCEPTED:
        a, b = bench.reader(name)(off), bench.reader(name)(on)
        if name.startswith("device."):
            # the profiler's own window length differs run to run; on the
            # CPU nothing is busy, so the share reads 100 both times
            assert a == b == pytest.approx(100.0) if "idle" in name \
                else a == b, name
        else:
            assert a == b, name
    assert [(r.tokens, r.stamps) for r in off.reqs.values()] \
        == [(r.tokens, r.stamps) for r in on.reqs.values()]
    sp = rec.spans()
    red = spans.reduce(events, sp)
    assert red["fit"]["n_pairs"] > 50
    assert red["fit"]["residual_p99_us"] < 1000.0
    read = spans.readings(on, sp, red)
    assert read["engine.prefill_ms_per_step"] > 0
    assert read["engine.first_token_hold_ms"] >= 0
    assert read["core.busy_ms_per_step"] > 0
    assert spans.spans_per_step(on, sp) > 5
