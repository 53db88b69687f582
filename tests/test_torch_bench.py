"""The port's two benches, bhnerf_tpu_torch.bench and
bhnerf_tpu_torch.bench_recovery, against the repository's bench.py and
bench_recovery.py, small on the host (device='cpu').

The root scripts are loaded with importlib (their import sets
JAX_PLATFORMS, which is restored right after); their `main` is never
called, and their `record` only on a copy in a temporary directory, where
it writes that directory's RECOVERY.json. Every trace is forced to 16
samples a ray and 256 fine steps, and the port's table cache and
RECOVERY.json go to the test's temporary directory.

Tolerances: the FLOP count, the in-domain sample counts, the frame draws
and the synthetic ray constants are exact (the same numpy draws); the
headline problem's in-domain count equal on the same npz table; the
sections' numbers finite and positive, the MFU keys null off the card
(no peak for the CPU), as is the power limit (no nvidia-smi).
"""
import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from bhnerf_tpu import emission as j_emission
from bhnerf_tpu import units as j_units
from bhnerf_tpu.geodesics.dataset import Geodesics as JGeodesics
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.train import raytracing_args as j_raytracing_args
from bhnerf_tpu.train import step as j_step

import torch

from bhnerf_tpu_torch import bench, bench_recovery
from bhnerf_tpu_torch.geodesics import dataset
from bhnerf_tpu_torch.models import NeRFPredictor
from bhnerf_tpu_torch.train import step
from _torch_cores import cores_per_worker  # noqa: F401 (autouse)
from _torch_cores import module_cores_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = dict(ngeo=16, n_fine=256)
SMALL = dict(num=8, ngeo=16, nt=8, n_fine=256)


def _load(path, name):
    """The script at `path` as a module named `name`; the JAX_PLATFORMS
    its import sets and its sys.path changes are undone."""
    env, saved = os.environ.get('JAX_PLATFORMS'), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path[:] = saved
        if env is None:
            os.environ.pop('JAX_PLATFORMS', None)
        else:
            os.environ['JAX_PLATFORMS'] = env


ref_bench = _load(os.path.join(REPO, 'bench.py'), 'reference_bench')


def _tree(name):
    with open(os.path.join(REPO, name)) as f:
        return ast.parse(f.read())


def _function(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _dict_keys(node):
    """The string keys of every dict literal under `node`."""
    return {k.value for d in ast.walk(node) if isinstance(d, ast.Dict)
            for k in d.keys if isinstance(k, ast.Constant)}


def _printed_keys(fn, name):
    """The keys of the dict literal that `fn` passes to json.dumps, or
    else assigns to `name`."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                getattr(node.func, 'attr', None) == 'dumps' and \
                isinstance(node.args[0], ast.Dict):
            return _dict_keys(node.args[0])
        if name and isinstance(node, ast.Assign) and \
                getattr(node.targets[0], 'id', None) == name:
            return _dict_keys(node.value)
    raise AssertionError(f'no printed dict in {fn.name}')


def _reference_keys():
    """{section: the keys the reference's bench.py gives}: main's line,
    and what bench_alma_shape, bench_eht_step and bench_device_geos
    return (the EHT keys are the 'eht_' strings it assigns, not the
    directory of the station tables)."""
    tree = _tree('bench.py')
    eht = {c.value for c in ast.walk(_function(tree, 'bench_eht_step'))
           if isinstance(c, ast.Constant) and isinstance(c.value, str)
           and c.value.startswith('eht_') and c.value != 'eht_arrays'}
    alma = _dict_keys(_function(tree, 'bench_alma_shape'))
    geos = _dict_keys(_function(tree, 'bench_device_geos'))
    line = _printed_keys(_function(tree, 'main'), None)
    return {'alma_shape': alma, 'eht_step': eht, 'device_geos': geos,
            'line': line | alma | eht | geos}


REFERENCE_KEYS = _reference_keys()
# null off the card: no peak for the CPU, no nvidia-smi
NULL_ON_CPU = {'mfu', 'alma_mfu', 'peak_tflops', 'power_limit_w',
               'cuda_version'}


def _forced(fn, **fixed):
    return lambda *args, **kwargs: fn(*args, **{**kwargs, **fixed})


def _finite(value):
    return all(np.isfinite(v) for v in np.ravel(value))


@pytest.fixture(scope='module')
def small(tmp_path_factory):
    """The port's traces forced to TRACE, its table cache in a temporary
    directory, and the headline problem at SMALL on the host."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dataset, 'trace_geodesics',
                   _forced(dataset.trace_geodesics, **TRACE))
        mp.setattr(bench, 'CACHE_DIR', str(tmp_path_factory.mktemp('geos')))
        mp.setenv('BENCH_REPS', '2')
        yield bench.headline_problem('cpu', **SMALL)


@pytest.mark.parametrize('depth,width,deg,skip', [
    (4, 128, 3, True), (4, 128, 3, False), (8, 256, 10, True),
    (2, 64, 0, True), (6, 32, 5, True)])
def test_mlp_flops_per_sample_match_reference(depth, width, deg, skip):
    pred = types.SimpleNamespace(net_depth=depth, net_width=width,
                                 posenc_deg=deg, do_skip=skip,
                                 out_channel=1)
    assert bench.mlp_flops_per_sample(pred) == \
        ref_bench.mlp_flops_per_sample(pred)
    # 4x128, posenc 3: 21 features, the skip after layer 2
    if (depth, width, deg, skip) == (4, 128, 3, True):
        assert bench.mlp_flops_per_sample(pred) == 2 * (
            21 * 128 + 2 * 128 * 128 + 149 * 128 + 128)


def test_rand_indices_match_reference():
    got = bench.rand_indices(np.random.default_rng(7), 64, 6, 20)
    want = ref_bench.rand_indices(np.random.default_rng(7), 64, 6, 20)
    assert len(got) == 21
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_synthetic_polarized_rt_bitwise():
    got = bench.synthetic_polarized_rt(6, 5, 16.0, None, seed=3,
                                       device='cpu')
    want = ref_bench.synthetic_polarized_rt(6, 5, 16.0, None, seed=3)
    for f in ('coords', 'Omega', 'J', 'g', 'dtau', 'Sigma', 't_geos_rel',
              't_injection'):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    assert (got.t_start_obs, got.t_to_M, got.t_units) == \
        (want.t_start_obs, want.t_to_M, want.t_units)


def test_alma_shape_compaction_counts_match_jax():
    """Three variants compacted in the 'gather' layout: each keeps the
    samples the JAX package keeps."""
    kw = dict(scale=8.0, rmin=3.0, rmax=8.0, z_width=2.0, net_width=32)
    got = step.compact_ensemble_args(
        [bench.synthetic_polarized_rt(12, 10, 16.0, None, seed=s,
                                      device='cpu') for s in range(3)],
        NeRFPredictor(**kw), layout='gather')
    want = j_step.compact_ensemble_args(
        [ref_bench.synthetic_polarized_rt(12, 10, 16.0, None, seed=s)
         for s in range(3)], JPredictor(**kw), layout='gather')
    counts = [int((c.t_geos_rel > -1e29).sum()) for c in got]
    assert counts == [int((np.asarray(c.t_geos_rel) > -1e29).sum())
                      for c in want]
    assert 0 < min(counts) and len({c.coords.shape for c in got}) == 1


def test_headline_n_eff_matches_reference(small):
    """n_eff of the headline problem equals the reference's
    domain_mask(...).sum() on the same npz table."""
    cache = bench.cache_path('bench', SMALL['num'], SMALL['ngeo'], 16.0,
                             SMALL['n_fine'])
    assert os.path.dirname(cache) == bench.CACHE_DIR or \
        os.path.exists(cache)
    geos = JGeodesics.load(cache)
    rt = j_raytracing_args(geos, geos.keplerian_omega(),
                           -float(geos.r_o + 4.0), j_units.Quantity(0.0, 'hr'))
    want = int(np.asarray(j_emission.domain_mask(rt.coords, 3.0, 8.0,
                                                 2.0)).sum())
    assert small.n_eff == want > 0
    assert int((small.crt.t_geos_rel > -1e29).sum()) == want
    assert small.predictor.compute_dtype == 'bfloat16'


@pytest.mark.parametrize('section', ['per_dispatch', 'scan', 'alma_shape',
                                     'eht_step', 'device_geos',
                                     'dense_baseline'])
def test_section_small_on_cpu(small, section):
    """Each section small on the host: the reference's keys, finite
    values (the MFU null off the card)."""
    p = small
    if section == 'per_dispatch':
        out = bench.bench_per_dispatch(p, n_steps=2)
        assert all(np.isfinite(out)) and out[0] > 0
        return
    if section == 'scan':
        rate, rates = bench.bench_scan(p, chunk=2, steps=4)
        assert len(rates) == 2 and rate > 0 and _finite(rates)
        return
    if section == 'dense_baseline':
        rate = bench.bench_dense_baseline(p, bench.mark, n_steps=1)
        assert np.isfinite(rate) and rate > 0
        return
    if section == 'alma_shape':
        out = bench.bench_alma_shape(p.predictor, bench.mark, num_variants=2,
                                     chunk=2, device='cpu', num=8, ngeo=8,
                                     nt=8, steps=4)
        assert out['alma_shape'] == [8, 8, 8, 3]
        assert out['alma_num_variants'] == 2
    elif section == 'eht_step':
        out = bench.bench_eht_step(
            p.predictor, p.geos, p.rt, p.crt,
            np.linspace(4.0, 15.5, p.nt).astype(np.float32), bench.mark,
            chunk=2, n_chunks=1, device='cpu')
        assert out['eht_nvis_per_frame'] > 0
    else:
        out = bench.bench_device_geos(bench.mark, n=4, device='cpu', **TRACE)
    assert set(out) == REFERENCE_KEYS[section]
    for key, value in out.items():
        if key in NULL_ON_CPU:
            assert value is None, key
        else:
            assert _finite(value) and np.all(np.asarray(value) > 0), key


def test_run_line_has_reference_keys(small, monkeypatch):
    """run(): every key of the reference's line, plus the card's power
    limit and the versions, on one JSON line; the sections forced
    small."""
    monkeypatch.setattr(bench, 'headline_problem',
                        _forced(bench.headline_problem, **SMALL))
    for name, kw in (('bench_per_dispatch', dict(n_steps=2)),
                     ('bench_scan', dict(chunk=2, steps=2)),
                     ('bench_alma_shape', dict(num_variants=2, chunk=2,
                                               num=8, ngeo=8, nt=8,
                                               steps=2)),
                     ('bench_eht_step', dict(chunk=2, n_chunks=1)),
                     ('bench_device_geos', dict(n=4, **TRACE)),
                     ('bench_dense_baseline', dict(n_steps=1))):
        monkeypatch.setattr(bench, name, _forced(getattr(bench, name), **kw))
    line = bench.run('cpu')
    assert json.loads(json.dumps(line)) == line
    assert REFERENCE_KEYS['line'] <= set(line)
    assert set(line) - REFERENCE_KEYS['line'] == {
        'power_limit_w', 'torch_version', 'cuda_version'}
    assert line['metric'] == 'train_ray_samples_per_sec'
    assert line['chip'] == 'cpu' and line['torch_version'] == \
        torch.__version__
    assert line['baseline_source'] == 'measured'
    assert line['alma_shape'] == [8, 8, 8, 3]
    for key, value in line.items():
        if key in NULL_ON_CPU:
            assert value is None, key
        elif key == 'steps_per_sec_spread' and value is None:
            # the per-dispatch path won: it has no spread
            assert line['per_dispatch_steps_per_sec'] > \
                line['scan_steps_per_sec']
        elif not isinstance(value, str):
            assert _finite(value), key


@pytest.mark.parametrize('mode', [
    dict(), dict(eht=True), dict(eht=True, npix=128)],
    ids=['image', 'eht', 'eht_npix128'])
def test_record_keys_match_reference(tmp_path, mode):
    """The port's record keys RECOVERY.json as the reference's does:
    time_to_recover, time_to_recover_eht and
    time_to_recover_eht_npix128_factored."""
    ref_dir = tmp_path / 'reference'
    ref_dir.mkdir()
    shutil.copy(os.path.join(REPO, 'bench_recovery.py'), ref_dir)
    ref = _load(str(ref_dir / 'bench_recovery.py'),
                'reference_bench_recovery')
    npix = mode.get('npix', 64)
    result = {'metric': ('time_to_recover_eht' if mode.get('eht')
                         else 'time_to_recover'),
              'wall_s': 1.0, 'psnr_3d': 50.0, 'lc_err_pct': 0.1,
              'num_iters': 10, 'npix': npix}
    if mode.get('eht'):
        result['operator'] = 'factored' if npix > 64 else 'dense'
    ref.record(dict(result))
    bench_recovery.record(dict(result), path=str(tmp_path / 'port.json'))
    want = json.loads((ref_dir / 'RECOVERY.json').read_text())
    got = json.loads((tmp_path / 'port.json').read_text())
    assert got == want
    assert list(got) == [{(): 'time_to_recover',
                          (True,): 'time_to_recover_eht',
                          (True, 128): 'time_to_recover_eht_npix128_'
                                       'factored'}[tuple(mode.values())]]


@pytest.mark.parametrize('eht', [False, True], ids=['image', 'eht'])
def test_bench_recovery_small_on_cpu(tmp_path, monkeypatch, eht):
    """bench_recovery.main(small=True) on the host for a few steps in
    chunks of 2 (a ragged tail): the reference's result keys plus the
    power limit, a finite psnr_3d and lc_err_pct, the line on stdout,
    and files written only under tmp_path."""
    package_record = bench_recovery.RECOVERY_PATH
    before = os.path.exists(package_record) and \
        os.stat(package_record).st_mtime_ns
    monkeypatch.setattr(dataset, 'trace_geodesics',
                        _forced(dataset.trace_geodesics, **TRACE))
    monkeypatch.setattr(bench, 'CACHE_DIR', str(tmp_path))
    monkeypatch.setattr(bench_recovery, 'RECOVERY_PATH',
                        str(tmp_path / 'RECOVERY.json'))
    monkeypatch.setenv('BENCH_SCAN_CHUNK', '2')
    run = bench_recovery.main(5, small=True, eht=eht, device='cpu')
    result = run.result
    tree = _tree('bench_recovery.py')
    want = _printed_keys(_function(tree, 'main'), 'result') | (
        {'operator'} if eht else set())
    assert set(result) == want | {'power_limit_w'}
    assert result['npix'] == 16 and result['num_iters'] == 5
    assert run.optimizer.state.step == 5
    assert np.isfinite(result['psnr_3d']) and \
        np.isfinite(result['lc_err_pct'])
    assert result['chip'] == 'cpu' and result['power_limit_w'] is None
    assert result.get('operator') == ('dense' if eht else None)
    key = 'time_to_recover_eht_npix16' if eht else 'time_to_recover_npix16'
    assert json.loads((tmp_path / 'RECOVERY.json').read_text()) == \
        {key: result}
    assert sorted(os.listdir(tmp_path)) == sorted([
        'RECOVERY.json', os.path.basename(
            bench.cache_path('rec', 16, 32, 16.0, 8192))])
    after = os.path.exists(package_record) and \
        os.stat(package_record).st_mtime_ns
    assert before == after


@pytest.mark.parametrize('module', ['bench', 'bench_recovery'])
def test_no_card_exits_2_with_a_null_line(module):
    """Without a CUDA device each entry point prints exactly one JSON
    line whose value is null and exits 2; neither imports JAX, the JAX
    package or a root script."""
    env = {**os.environ, 'CUDA_VISIBLE_DEVICES': ''}
    env.pop('PYTHONPATH', None)
    out = subprocess.run(
        [sys.executable, '-c',
         'import runpy, sys\n'
         'try:\n'
         f'    runpy.run_module("bhnerf_tpu_torch.{module}", '
         'run_name="__main__")\n'
         'finally:\n'
         '    bad = sorted(m for m in sys.modules if m.split(".")[0] in '
         '("jax", "bhnerf_tpu", "bench", "bench_recovery"))\n'
         '    print("# imported:", bad, file=sys.stderr)\n'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line['value'] is None and line['error'] == 'no CUDA device'
    assert line['metric'] == {'bench': 'train_ray_samples_per_sec',
                              'bench_recovery': 'time_to_recover'}[module]
    assert '# imported: []' in out.stderr


@pytest.mark.parametrize('script', ['bench.py', 'bench_recovery.py'])
def test_port_has_every_function_of_the_script(script):
    """Every top-level function of the root script (read with ast) is in
    its port under the same name, but for ROADMAP's "Do not port"
    ensure_tpu_reachable; and the port imports neither JAX, the JAX
    package nor a root script."""
    names = [n.name for n in _tree(script).body
             if isinstance(n, ast.FunctionDef)
             and n.name != 'ensure_tpu_reachable']
    port = {'bench.py': bench, 'bench_recovery.py': bench_recovery}[script]
    assert names and [n for n in names if not hasattr(port, n)] == []
    with open(port.__file__) as f:
        nodes = list(ast.walk(ast.parse(f.read())))
    imported = {alias.name.split('.')[0] for node in nodes
                if isinstance(node, ast.Import) for alias in node.names} | {
        node.module.split('.')[0] for node in nodes
        if isinstance(node, ast.ImportFrom) and node.module}
    assert not imported & {'jax', 'bhnerf_tpu', 'bench', 'bench_recovery'}
