"""ttft_mean_ms: mean over every request due in the window of due time to
first token (host clock); a request still waiting at the close counts
with its wait so far."""


def read(run):
    waits = run.ttfts()
    return 1e3 * sum(waits) / len(waits) if waits else None
