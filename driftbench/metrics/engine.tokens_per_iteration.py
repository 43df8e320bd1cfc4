"""engine.tokens_per_iteration: output tokens emitted per engine step,
over the window's steps (first tokens of prefills included)."""


def read(run):
    steps = run.window_steps()
    if not steps:
        return None
    return sum(n for _, _, n, _ in steps) / len(steps)
