"""The whole step's share of the card's dense bf16 peak (the port bench's
convention): 3 x the forward's FLOPs a step (forward + 2 x backward) x
steps/s of the unprofiled stretch over 989 TFLOP/s."""
from benchmark.metrics import _work


def read(run):
    if run.trace is None:
        return None
    flops, _ = _work.forward_work(run.work)
    return 100.0 * 3 * flops / _work.step_seconds(run) / _work.STEP_PEAK_FLOPS
