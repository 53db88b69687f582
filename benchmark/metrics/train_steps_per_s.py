"""Steps of the chunked loop completed in the window over the window's
seconds (the window closes at a chunk boundary, after a synchronize)."""


def read(run):
    if run.loop != 'chunked' or run.trace is not None:
        return None
    return run.window.steps / run.window.elapsed
