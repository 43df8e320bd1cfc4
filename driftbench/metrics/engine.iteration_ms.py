"""engine.iteration_ms: mean host wall of ``ServingEngine.step`` over
the window's steps outside the profiled sub-window."""


def read(run):
    steps = run.window_steps(unprofiled=True)
    if not steps:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _, _ in steps) / len(steps)
