"""The window's arithmetic: which requests and tokens count, and how a
stall shows in the tails (requests still waiting at the close count
with their wait so far; a token held up shows as one long gap)."""

from types import SimpleNamespace

import pytest

from driftbench import bench
from driftbench.gen.traffic import Record
from driftbench.record import ReqLog, Run, percentile


def _req(due, stamps, target, dispatch=None, done=None):
    rec = Record(due=due, tenant="standard", category="short_qa", prompt="p",
                 prompt_tokens=3, max_tokens=64,
                 true_output_tokens=target)
    req = SimpleNamespace(dispatch_time=dispatch, completion_time=done,
                          estimate=SimpleNamespace(est_output_tokens=10.0))
    r = ReqLog(rec=rec, req=req, bucket=16, target=target)
    r.stamps = list(stamps)
    r.tokens = [1] * len(stamps)
    return r


def _run(reqs):
    return Run(cell=None, seed=0, t_open=10.0, t_close=20.0, setup_s=1.0,
               reqs=dict(enumerate(reqs)), steps=[])


def test_percentile_is_linear_between_order_statistics():
    assert percentile([], 95) is None
    assert percentile([5.0], 95) == 5.0
    assert percentile(list(range(101)), 95) == pytest.approx(95.0)
    assert percentile([0.0, 10.0], 95) == pytest.approx(9.5)


def test_a_stall_shows_in_ttft_and_gaps():
    reqs = [
        _req(5.0, [5.1, 5.2, 11.0], 3, 5.0, 11.0),     # due before: not counted
        _req(12.0, [12.1, 12.2, 12.3], 3, 12.0, 12.3),
        _req(13.0, [13.1, 17.1], 4, 13.0),             # stalled 4 s, open
        _req(19.0, [], 5),                             # waiting at the close
        _req(20.0, [20.1], 2),                         # due after the close
    ]
    run = _run(reqs)
    assert [r.rec.due for r in run.due_in_window()] == [12.0, 13.0, 19.0]
    assert run.ttfts() == pytest.approx([0.1, 0.1, 1.0])
    # 0.1, 0.1 of the second; the 4 s stall and the 2.9 s open gap
    assert sorted(run.token_gaps()) == pytest.approx([0.1, 0.1, 2.9, 4.0])
    assert run.tokens_in_window() == 1 + 3 + 2
    assert bench.reader("ttft_p95_ms")(run) == pytest.approx(910.0)
    assert bench.reader("itl_p95_ms")(run) == pytest.approx(
        1e3 * percentile([0.1, 0.1, 2.9, 4.0], 95))
    assert bench.reader("output_tokens_per_s")(run) == pytest.approx(0.6)
    assert bench.reader("core.queue_wait_p95_ms")(run) == pytest.approx(
        1e3 * percentile([0.0, 0.0, 1.0], 95))
    assert bench.reader("core.estimate_mae_tokens")(run) == pytest.approx(7.0)


def test_readers_return_nothing_without_their_data():
    run = _run([])
    for name in ("ttft_p95_ms", "itl_p95_ms", "engine.iteration_ms",
                 "model.decode_mfu", "model.prefill_mfu", "device.idle_share",
                 "device.window_mfu", "kernels.flash_attention_roofline",
                 "core.estimate_mae_tokens", "engine.tokens_per_iteration"):
        assert bench.reader(name)(run) is None, name
