"""Idle share of the device in the per-step loop: 1 - busy a step (the
profiled steps) / a step's time in the unprofiled stretch."""
from benchmark.metrics import _work


def read(run):
    return _work.idle_percent(run, 'per_step')
