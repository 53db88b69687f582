"""Device ms a step of every operation that is not a render kernel: the
per-pixel reduction or lightcurve product, the chi-square, the frame
gathers, Adam, copies and fills."""
from benchmark.metrics import _work


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds(
        lambda n: not (_work.is_forward(n) or _work.is_backward(n)))
    return 1e3 * _work.per_profiled_step(run, seconds)
