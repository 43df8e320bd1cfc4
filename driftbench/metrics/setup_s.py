"""setup_s: process start to the window's open: imports, the card, the
weights, every kernel build and first call of the traffic's shapes, and
the traffic warm-up (host clock)."""


def read(run):
    return run.setup_s
