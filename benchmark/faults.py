"""Faults planted under the timed path, to show that the check fails
them: a step that leaves the state unchanged, and a step that leaves out
half of its frame batch and takes the mean over the rest. Each is a
context manager that patches the port while it is open."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def state_unchanged():
    """TrainState.apply_gradients counts the step and updates nothing."""
    from bhnerf_tpu_torch.train import state

    def apply_gradients(self):
        self.step += 1

    with _patched(state.TrainState, 'apply_gradients', apply_gradients):
        yield


@contextlib.contextmanager
def half_batch():
    """TrainStep's call renders the first half of its frames alone, its
    loss scaled by two: the mean over the rest, at the batch's scale."""
    from bhnerf_tpu_torch.train import TrainStep
    call = TrainStep.__call__

    def half(self, state, raytracing_args, indices, update_state=True,
             variant=None):
        scale = self.scale
        self.scale = [2.0 * s for s in scale]
        try:
            return call(self, state, raytracing_args,
                        indices[:len(indices) // 2], update_state, variant)
        finally:
            self.scale = scale

    with _patched(TrainStep, '__call__', half):
        yield


FAULTS = {'state_unchanged': state_unchanged, 'half_batch': half_batch}


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)
