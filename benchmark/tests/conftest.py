"""Shared fixtures of the benchmark's tests: a tiny configuration of each
cell that a CPU run holds (8x8 rays, 16 samples a ray, a 32-wide MLP)."""
from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(workload):
    """(bench, cell, cfg, traffic) of `workload` (measured or parked) cut to
    a CPU test's size."""
    from benchmark import run
    bench = run.manifest(parked=True)
    cell, cfg, traffic = run.cell_of(bench, workload)
    cfg = dict(cfg, num_alpha=8, num_beta=8, ngeo=16, n_fine=256,
               net_width=32, check_pixels=8, num_frames=12)
    traffic = dict(traffic, chunk=5, batch=4, trace_steps=5, warmup_steps=3,
                   variants=min(traffic['variants'], 3))
    return bench, cell, cfg, traffic


@pytest.fixture
def cpu_args():
    return types.SimpleNamespace(seed=2**33 + 7, seconds=0.5, trace=0)
