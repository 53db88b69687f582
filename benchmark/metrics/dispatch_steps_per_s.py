"""Steps of the per-step loop completed in the window over the window's
seconds (the window closes after a synchronize)."""


def read(run):
    if run.loop != 'per_step' or run.trace is not None:
        return None
    return run.window.steps / run.window.elapsed
