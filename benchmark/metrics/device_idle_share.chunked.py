"""Idle share of the device in the chunked loop: 1 - busy a step (the
profiled chunk) / a step's time in the unprofiled stretch."""
from benchmark.metrics import _work


def read(run):
    return _work.idle_percent(run, 'chunked')
