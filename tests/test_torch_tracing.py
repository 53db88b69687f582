"""The port's spans and counters (`bhnerf_tpu_torch.tracing`) on a tiny fit
on the CPU: seeded 8x8x16 ray constants compacted in the 'gather' layout,
a 2x32 MLP and a 10-frame movie, through Optimizer.run per step and in
chunks. Tracing off records nothing and tracing on changes no loss; the
span tree, the summary's self times and the counters follow the loop.
"""
import glob
import json

import numpy as np
import pytest
import torch

from bhnerf_tpu_torch import tracing, units
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.parallel import mesh as mesh_lib
from bhnerf_tpu_torch.train import step
from bhnerf_tpu_torch.train.logging import profile_trace
from bhnerf_tpu_torch.train.optimizer import LogFn, Optimizer, TrainStep

NT, BATCH, STEPS, CHUNK = 10, 4, 12, 4
PRED = NeRFPredictor(scale=8.0, rmax=8.0, z_width=2.0, net_depth=2,
                     net_width=32)


@pytest.fixture(scope='module')
def problem():
    rng = np.random.default_rng(0)
    shape = (8, 8, 16)
    fields = dict(
        coords=np.stack([rng.uniform(-7, 7, shape), rng.uniform(-7, 7, shape),
                         rng.uniform(-2.5, 2.5, shape)]),
        Omega=rng.uniform(0.02, 0.08, shape), g=rng.uniform(0.5, 1.5, shape),
        dtau=rng.uniform(0.5, 1.0, shape), Sigma=rng.uniform(0.5, 1.0, shape),
        t_geos_rel=rng.uniform(0.0, 50.0, shape))
    rt = step.RayTracingArgs(
        **{k: torch.as_tensor(v.astype(np.float32)) for k, v in
           fields.items()}, J=1.0, t_injection=torch.zeros(()), t_to_M=100.0,
        t_units=units.hr)
    crt = step.compact_raytracing_args(rt, PRED, layout='gather')
    target = (0.02 * rng.random((NT, 8, 8))).astype(np.float32)
    t_q = units.Quantity(np.linspace(0.0, 0.05, NT), 'hr')
    train_step = TrainStep.image(t_q, target, PRED, fused=True, device='cpu')
    return crt, train_step


@pytest.fixture(autouse=True)
def clean():
    """Spans off and no records left, before and after each test."""
    tracing.disable()
    tracing.records()
    yield
    tracing.disable()
    tracing.records()


def _fit(problem, scan_chunk, traced, log=True, nan_check_period=1000):
    """Optimizer.run over STEPS steps: (loss series or None, the records
    of the run, the counters it added)."""
    crt, train_step = problem
    opt = Optimizer({'num_iters': STEPS, 'lr_init': 1e-3, 'seed': 3}, PRED,
                    crt, device='cpu')
    seen = []
    fns = [LogFn(lambda o: seen.append(float(o.loss)))] if log else []
    before = tracing.counters.copy()
    if traced:
        tracing.enable()
    opt.run(BATCH, train_step, crt, log_fns=fns, verbose=False,
            scan_chunk=scan_chunk, nan_check_period=nan_check_period)
    tracing.disable()
    added = {k: (n - before.counts.get(k, 0),
                 tracing.counters.totals[k] - before.totals.get(k, 0))
             for k, n in tracing.counters.counts.items()
             if n != before.counts.get(k, 0)}
    return (seen if log else None), tracing.records(), added


@pytest.mark.parametrize('scan_chunk', [0, CHUNK])
def test_off_records_nothing_and_on_changes_no_loss(problem, scan_chunk):
    off, recs, _ = _fit(problem, scan_chunk, traced=False)
    assert recs == [] and len(off) == STEPS
    on, recs, _ = _fit(problem, scan_chunk, traced=True)
    assert recs and np.array_equal(np.asarray(on), np.asarray(off))


def test_off_span_is_one_shared_no_op():
    assert tracing.span('bhnerf.a') is tracing.span('bhnerf.b')
    with tracing.span('bhnerf.a'):
        pass
    assert tracing.records() == []


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def _self_times_add_up(recs):
    """The summary's self times sum to the roots' total."""
    total = sum(r.end_ns - r.start_ns for r in recs if r.parent is None)
    summed = sum(s['self_ms'] for s in tracing.summary(recs).values())
    assert summed == pytest.approx(total * 1e-6, rel=1e-9)


def test_span_tree_of_the_per_step_loop(problem):
    _, recs, _ = _fit(problem, 0, traced=True, nan_check_period=5)
    names = _by_name(recs)
    ids = {r.id: r for r in recs}
    [run] = names['bhnerf.loop.run']
    steps = names['bhnerf.loop.step']
    assert [r.step for r in steps] == list(range(1, STEPS + 1))
    assert all(r.parent == run.id for r in steps)
    by_step = {r.id: r.step for r in steps}
    for name in ('bhnerf.loop.draw', 'bhnerf.loop.upload',
                 'bhnerf.loop.callbacks', 'bhnerf.step.zero_grad',
                 'bhnerf.step.forward', 'bhnerf.step.backward',
                 'bhnerf.step.update'):
        assert len(names[name]) == STEPS, name
        for r in names[name]:
            assert by_step[r.parent] == r.step
            parent = ids[r.parent]
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    assert [r.step for r in names['bhnerf.loop.guard']] == [5, 10]
    assert 'bhnerf.step.allreduce' not in names     # no mesh
    assert run.step is None
    _self_times_add_up(recs)


def test_span_tree_of_the_chunked_loop(problem):
    _, recs, _ = _fit(problem, CHUNK, traced=True, log=False)
    names = _by_name(recs)
    [run] = names['bhnerf.loop.run']
    chunks = names['bhnerf.loop.chunk']
    assert [r.step for r in chunks] == [1, 5, 9]
    assert [r.step for r in names['bhnerf.loop.guard']] == [1, 5, 9]
    assert all(r.parent == run.id for r in chunks + names['bhnerf.loop.guard'])
    chunk_of = {r.id: r.step for r in chunks}
    for name in ('bhnerf.loop.draw', 'bhnerf.loop.upload'):
        assert [chunk_of[r.parent] for r in names[name]] == [1, 5, 9]
    forward = names['bhnerf.step.forward']
    assert len(forward) == STEPS
    assert [chunk_of[r.parent] for r in forward] == [1] * 4 + [5] * 4 + [9] * 4
    assert [r.step for r in forward] == [1] * 4 + [5] * 4 + [9] * 4
    assert 'bhnerf.loop.step' not in names
    _self_times_add_up(recs)


def test_counters_of_both_loops(problem):
    _, _, added = _fit(problem, 0, traced=False, log=False)
    syncs = {k: v for k, v in added.items() if k.startswith('host_syncs.')}
    assert syncs == {'host_syncs.index_copy': (STEPS, 0)}
    assert added['h2d.index_copy'] == (STEPS, STEPS * BATCH * 8)
    _, _, added = _fit(problem, CHUNK, traced=False, log=False)
    syncs = {k: v for k, v in added.items() if k.startswith('host_syncs.')}
    assert syncs == {'host_syncs.guard': (STEPS // CHUNK, 0)}
    assert added['h2d.chunk_upload'] == (STEPS // CHUNK, STEPS * BATCH * 8)
    # a per-step callback in the chunked loop reads each chunk's losses
    _, _, added = _fit(problem, CHUNK, traced=False, log=True)
    assert added['host_syncs.replay'] == (STEPS // CHUNK, 0)
    # the loop counts its syncs and copies only: kernel launches are
    # counted on the kernels' wrappers (`fused.render_fwd.launches`)
    assert {k.split('.')[0] for k in added} == {'host_syncs', 'h2d'}


def test_records_leave_open_spans_for_later():
    tracing.enable()
    with tracing.span('bhnerf.outer'):
        with tracing.span('bhnerf.inner'):
            pass
        first = tracing.records()
    second = tracing.records()
    assert [r.name for r in first] == ['bhnerf.inner']
    assert [r.name for r in second] == ['bhnerf.outer']
    assert first[0].parent == second[0].id and second[0].parent is None


def test_precompute_and_setup_spans(problem):
    crt, train_step = problem
    tracing.enable()
    Optimizer({'num_iters': 1}, PRED, crt, device='cpu')
    TrainStep.image(units.Quantity(np.linspace(0, 1, 4), 'hr'),
                    np.zeros((4, 8, 8), np.float32), PRED, device='cpu')
    names = [r.name for r in tracing.records()]
    assert names == ['bhnerf.setup.optimizer', 'bhnerf.setup.train_step']


def test_profile_trace_shows_spans_and_restores_the_flag(problem, tmp_path):
    crt, train_step = problem
    opt = Optimizer({'num_iters': 2, 'seed': 3}, PRED, crt, device='cpu')
    with profile_trace(tmp_path):
        opt.run(BATCH, train_step, crt, verbose=False)
    assert tracing.span('bhnerf.x') is tracing.span('bhnerf.y')   # off
    assert len(_by_name(tracing.records())['bhnerf.loop.step']) == 2
    [path] = glob.glob(str(tmp_path / '*.json'))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    steps = [e for e in events if e.get('name') == 'bhnerf.loop.step'
             and e.get('cat') == 'user_annotation']
    assert len(steps) == 2


def test_mesh_census_is_the_tracing_census():
    assert mesh_lib.Census is tracing.Census
    mesh = mesh_lib.Mesh({'data': 1, 'ray': 1})
    mesh.census.add(mesh_lib._census_key('gradients', ('data', 'ray')), 7)
    mesh.census.add(mesh_lib._census_key('gradients', ('data', 'ray')), 3)
    assert mesh.census.as_dict() == {
        'gradients over data+ray': {'count': 2, 'largest': 7}}
