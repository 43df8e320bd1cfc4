"""output_tokens_per_s: every output token stamped inside the window,
of any request, over the window's length (host clock)."""


def read(run):
    return run.tokens_in_window() / run.window_s
