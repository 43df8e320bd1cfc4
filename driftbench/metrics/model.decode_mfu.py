"""model.decode_mfu: model FLOPs of the live lanes' decode tokens over
the wall of the model's decode calls (``api.decode_step``, or the paged
pool's ``decode_step_paged``; synchronised), against 989 TFLOP/s, over
the window's calls outside the profiled sub-window."""

from driftbench.flops import PEAK_FLOPS


def read(run):
    calls = run.window_calls(run.decodes, unprofiled=True)
    wall = sum(c.t1 - c.t0 for c in calls)
    if not calls or wall <= 0:
        return None
    return 100.0 * sum(c.flops for c in calls) / wall / PEAK_FLOPS
