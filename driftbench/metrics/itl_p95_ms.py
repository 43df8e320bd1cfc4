"""itl_p95_ms: 95th percentile over every gap between consecutive
output tokens of one request, over all requests due in the window
(host clock; open gaps at the close included)."""

from driftbench.record import percentile


def read(run):
    v = percentile(run.token_gaps(), 95)
    return None if v is None else 1e3 * v
