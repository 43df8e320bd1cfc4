"""ttft_p95_ms: 95th percentile over every request due in the window of
due time to first token (host clock); a request still waiting at the
close counts with its wait so far."""

from driftbench.record import percentile


def read(run):
    v = percentile(run.ttfts(), 95)
    return None if v is None else 1e3 * v
