"""The readers of the program's spans and counters (`benchmark/spans.py`,
`benchmark/metrics/host_syncs_per_step.py`) on hand-made records and on
the records of a tiny run with spans on, and `idle_by_span` on a
hand-made event list."""
from __future__ import annotations

import importlib
import types

import pytest

from benchmark import run, spans
from bhnerf_tpu_torch import tracing

MS = 1_000_000          # ns


def rec(i, name, start_ms, end_ms, parent=None, step=None):
    return tracing.Record(i, name, start_ms * MS, end_ms * MS, parent, step)


def _run(loop, window=(), setup=(), idle=None, steps=100, profiled_steps=10):
    return types.SimpleNamespace(
        loop=loop, spans={'setup': list(setup), 'window': list(window)},
        window=types.SimpleNamespace(steps=steps),
        profiled=types.SimpleNamespace(steps=profiled_steps, step0=0),
        trace=types.SimpleNamespace(idle_by_span=idle))


def test_idle_by_span_takes_the_innermost_span():
    kernel = lambda ts, dur: {'ph': 'X', 'cat': 'kernel', 'name': 'k',
                              'ts': ts, 'dur': dur}
    note = lambda name, ts, dur: {'ph': 'X', 'cat': 'user_annotation',
                                  'name': name, 'ts': ts, 'dur': dur}
    events = [
        kernel(0, 10), kernel(30, 10), kernel(100, 10), kernel(130, 10),
        note('bhnerf.loop.step', 5, 110),
        note('bhnerf.step.backward', 12, 25),    # over the gap 10-30
        note('aten::copy_', 40, 60),             # not a program span
        note('Optimizer.zero_grad#Adam.zero_grad', 45, 40),
    ]
    idle = spans.idle_by_span(events)
    assert idle['bhnerf.step.backward'] == pytest.approx(20e-6)
    assert idle['bhnerf.loop.step'] == pytest.approx(60e-6)    # 40-100
    assert idle['none'] == pytest.approx(20e-6)                # 110-130
    assert set(idle) == {'bhnerf.step.backward', 'bhnerf.loop.step', 'none'}


def test_idle_by_span_siblings_and_no_gap():
    events = [{'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': t, 'dur': 1}
              for t in (0, 10, 20)]
    events += [{'ph': 'X', 'cat': 'user_annotation', 'name': n, 'ts': a,
                'dur': 3} for n, a in (('bhnerf.loop.draw', 3),
                                       ('bhnerf.loop.upload', 14))]
    idle = spans.idle_by_span(events)
    assert idle == {'bhnerf.loop.draw': pytest.approx(9e-6),
                    'bhnerf.loop.upload': pytest.approx(9e-6)}
    assert spans.idle_by_span(events[:1]) == {}


def test_step_host_ms_leaves_out_the_callbacks():
    window = []
    for s in range(5):
        t = 10 * s
        window += [rec(3 * s, 'bhnerf.loop.step', t, t + 8, step=s + 1),
                   rec(3 * s + 1, 'bhnerf.loop.draw', t, t + 1, 3 * s),
                   rec(3 * s + 2, 'bhnerf.loop.callbacks', t + 4, t + 4 + s,
                       3 * s)]
    # 8, 7, 6, 5, 4 ms of host work a step
    assert spans.step_host_ms(_run('per_step', window)) == \
        pytest.approx(6.0)
    assert spans.step_host_ms(_run('chunked', window)) is None
    untraced = _run('per_step', window)
    untraced.profiled = None
    assert spans.step_host_ms(untraced) is None


def test_chunk_boundary_ms():
    window = [rec(0, 'bhnerf.loop.chunk', 0, 100, step=1),
              rec(1, 'bhnerf.step.forward', 5, 6, 0, 1),
              rec(2, 'bhnerf.loop.guard', 100, 130),
              rec(3, 'bhnerf.loop.callbacks', 130, 131),
              rec(4, 'bhnerf.loop.chunk', 131, 200, step=501),
              rec(5, 'bhnerf.loop.draw', 131, 140, 4, 501),
              rec(6, 'bhnerf.step.zero_grad', 142, 143, 4, 501),
              rec(7, 'bhnerf.step.forward', 143, 144, 4, 501),
              rec(8, 'bhnerf.loop.guard', 200, 210),
              rec(9, 'bhnerf.loop.chunk', 210, 300, step=1001),
              rec(10, 'bhnerf.step.zero_grad', 216, 217, 9, 1001),
              rec(11, 'bhnerf.loop.guard', 300, 301)]
    r = _run('chunked', reversed(window))          # any order
    assert spans.chunk_boundary_ms(r) == pytest.approx((12 + 6) / 2)
    assert spans.chunk_boundary_ms(_run('per_step', window)) is None
    assert spans.chunk_boundary_ms(_run('chunked', window[:4])) is None


def test_idle_by_loop_and_step_spans_a_step():
    idle = {'bhnerf.loop.upload': 0.004, 'bhnerf.loop.callbacks': 0.006,
            'bhnerf.step.forward': 0.001, 'bhnerf.step.backward': 0.002,
            'none': 0.5}
    r = _run('per_step', idle=idle, profiled_steps=10)
    assert spans.idle_loop_ms(r) == pytest.approx(1.0)
    assert spans.idle_step_ms(r) == pytest.approx(0.3)
    assert spans.idle_loop_ms(_run('per_step')) is None     # untraced
    assert spans.idle_step_ms(_run('chunked', idle=idle)) is None
    no_spans = types.SimpleNamespace(loop='per_step', profiled=None,
                                     trace=None)     # run.py's run
    assert all(read(no_spans) is None for read in spans.READERS.values())


def test_geodesics_s_sums_set_up():
    setup = [rec(0, 'bhnerf.precompute.geodesics', 0, 6500),
             rec(1, 'bhnerf.precompute.ray_constants', 6500, 7000),
             rec(2, 'bhnerf.precompute.geodesics', 7000, 8000)]
    assert spans.geodesics_s(_run('chunked', setup=setup)) == \
        pytest.approx(7.5)
    assert spans.geodesics_s(_run('chunked')) is None


def test_host_syncs_per_step_reads_the_program_counters(monkeypatch):
    census = tracing.Census()
    for _ in range(1001):
        census.add('host_syncs.index_copy')
    census.add('host_syncs.nan_check')
    census.add('h2d.index_copy', 48)
    monkeypatch.setattr(tracing, 'counters', census)
    read = run.reader('host_syncs_per_step')
    r = _run('per_step')
    r.profiled = types.SimpleNamespace(step0=701, steps=300)
    assert read(r) == pytest.approx(1002 / 1001)
    assert read(_run('chunked')) is None
    r.profiled = None                                       # untraced
    assert read(r) is None


@pytest.mark.parametrize('workload', ['t3_image.chunk500',
                                      't3_image.per_step'])
def test_a_run_with_spans_on_the_cpu(workload, cpu_args):
    """A tiny cell on the CPU with spans on, cut as the readers expect:
    every reader of its loop finds its spans among the program's."""
    import torch
    from benchmark.tests.conftest import tiny
    _, cell, cfg, traffic = tiny(workload)
    device = torch.device('cpu')
    kind = importlib.import_module(f'benchmark.kinds.{cfg["kind"]}')
    tracing.enable()
    try:
        fit = kind.build(cfg, traffic, cpu_args.seed, device,
                         run.Phases(device))
        fit.check_steps()
        fit.warm_up()
        setup = tracing.records()
        steps = 3 * (fit.chunk or traffic['trace_steps'])   # 2 boundaries
        window = fit.window(kind.Stop(device, max_steps=steps,
                                      step_times=True))
        recs = tracing.records()
    finally:
        tracing.disable()
        tracing.records()
    r = types.SimpleNamespace(
        loop=traffic['loop'], window=window, profiled=window,
        spans={'setup': setup, 'window': recs},
        trace=types.SimpleNamespace(idle_by_span={}))   # no device here
    m = {k: read(r) for k, read in spans.READERS.items()}
    assert m['geodesics_s'] > 0
    if traffic['loop'] == 'per_step':
        assert m['step_host_ms'] > 0 and m['chunk_boundary_ms'] is None
        assert m['idle_loop_ms.per_step'] == m['idle_step_ms.per_step'] == 0
    else:
        assert m['chunk_boundary_ms'] > 0 and m['step_host_ms'] is None
        assert m['idle_loop_ms.per_step'] is None
