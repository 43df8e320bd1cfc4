"""device.idle_share: share of the profiled sub-window in which no
kernel, copy or set ran on the card (device trace: one minus the union
of device intervals over the sub-window)."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
