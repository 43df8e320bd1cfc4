"""core.queue_wait_p95_ms: 95th percentile, over requests due in the
window, of due time to the scheduler's dispatch (the program's
``Request.dispatch_time``, stamped with the harness's clock); one not
dispatched by the close counts with its wait so far."""

from driftbench.record import percentile


def read(run):
    waits = []
    for r in run.due_in_window():
        t = r.req.dispatch_time
        t = run.t_close if t is None else min(t, run.t_close)
        waits.append(t - r.rec.due)
    v = percentile(waits, 95)
    return None if v is None else 1e3 * v
