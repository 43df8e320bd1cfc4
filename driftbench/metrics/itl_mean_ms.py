"""itl_mean_ms: mean over every gap between consecutive output tokens of
one request, over all requests due in the window (host clock; open gaps
at the close included): the pace a user reads at, over all the window's
work."""


def read(run):
    gaps = run.token_gaps()
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
