"""device.window_mfu: model FLOPs of every live token the model
computed in the window (prefills and decode steps) over the window's
length, against 989 TFLOP/s."""

from driftbench.flops import PEAK_FLOPS


def read(run):
    calls = run.window_calls(run.prefills) + run.window_calls(run.decodes)
    if not calls:
        return None
    return 100.0 * sum(c.flops for c in calls) / run.window_s / PEAK_FLOPS
