"""The synthetic-flare workflow of bhnerf_tpu_torch against bhnerf_tpu:
generate_synthetic_lightcurves and fit_synthetic_lp_flares (counterparts
of scripts/generate_synthetic_lightcurves.py and
scripts/fit_synthetic_lp_flares.py; the chi^2 example that follows them
is tests/test_torch_chi2_grid.py).

Small sizes: 8x8 rays, and every trace of both packages at TRACE (both
scripts trace at trace_geodesics' defaults, which the port's host loop
cannot afford here: the packages' trace_geodesics are patched for the
call). The generators' lightcurves agree within 1e-4 of the I maximum
(the renders agree to 5e-5 of their maximum, tests/test_torch_recovery.py)
and their flares to rtol 1e-6. The fit's losses are held against the JAX
package's TrainStep on the same ray constants and params; the sweep's
compacted constants carry 2-row Stokes weights (Q and U), whose 'lc' loss
and gradients, the offset's included, are held as tests/test_torch_alma.py
holds the 3-row ones.
"""
import contextlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp

from bhnerf_tpu import units as j_units
from bhnerf_tpu.geodesics import dataset as j_dataset
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.train import TrainState as JTrainState
from bhnerf_tpu.train import TrainStep as JTrainStep
from bhnerf_tpu.train import make_optimizer as j_make_optimizer
from bhnerf_tpu.train import step as j_step
from bhnerf_tpu.train import total_movie_loss as j_total_movie_loss

import torch

from bhnerf_tpu_torch import alma, config, units
from bhnerf_tpu_torch.geodesics import dataset
from bhnerf_tpu_torch.models.fields import NeRFPredictor, params_to_numpy
from bhnerf_tpu_torch.ops import fused
from bhnerf_tpu_torch.scripts import fit_synthetic_lp_flares as fit
from bhnerf_tpu_torch.scripts import generate_synthetic_lightcurves as gen
from bhnerf_tpu_torch.train import state as state_lib
from bhnerf_tpu_torch.train import step
from bhnerf_tpu_torch.train.logging import MemoryWriter
from bhnerf_tpu_torch.train.optimizer import total_movie_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = dict(ngeo=16, n_fine=256)
# 40 frames over 2 hours: the fit's split at 103 minutes keeps 34
GEN_ARGS = ['--num_alpha', '8', '--num_beta', '8', '--nt', '40',
            '--duration', '2.0', '--noise', '0.01', '--seed', '3']


def _forced(fn, **fixed):
    return lambda *args, **kwargs: fn(*args, **{**kwargs, **fixed})


@contextlib.contextmanager
def small_traces():
    """Both packages' trace_geodesics at TRACE (the port's alma binds its
    own name for the one-trace ensemble)."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (dataset, j_dataset, alma):
            mp.setattr(module, 'trace_geodesics',
                       _forced(module.trace_geodesics, **TRACE))
        yield


def _reference_module(*path):
    spec = importlib.util.spec_from_file_location(
        path[-1][:-3], os.path.join(REPO, *path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module', params=['hotspot', 'tube', 'double'])
def generated(request, tmp_path_factory):
    """Both generator scripts on one source, each into its own directory
    (the port's on the host, DRIVE_CPU=1)."""
    source = request.param
    root = tmp_path_factory.mktemp(f'gen_{source}')
    args = GEN_ARGS + ['--source', source, '--name', source]
    with small_traces(), pytest.MonkeyPatch.context() as mp:
        mp.setenv('DRIVE_CPU', '1')
        gen.main(args + ['--out', str(root / 'port')])
        mp.setattr(sys, 'argv', ['generate_synthetic_lightcurves.py']
                   + args + ['--out', str(root / 'jax')])
        _reference_module('scripts',
                          'generate_synthetic_lightcurves.py').main()
    return source, root


def _read(root, name):
    import pandas as pd
    return (pd.read_csv(root / f'{name}_lightcurves.csv'),
            np.load(root / f'{name}_flare.npz'),
            yaml.safe_load((root / f'{name}.yaml').read_text()))


def test_generated_data_matches_jax(generated):
    """The CSV's times exactly and its I, Q, U within 1e-4 of the largest
    I; the flare's volume at rtol 1e-6 and its extent exactly; the yaml's
    model block equal."""
    source, root = generated
    (csv, flare, sim), (j_csv, j_flare, j_sim) = (
        _read(root / side, source) for side in ('port', 'jax'))
    assert list(csv.columns) == list(j_csv.columns) == ['t', 'I', 'Q', 'U']
    np.testing.assert_array_equal(csv['t'], j_csv['t'])
    scale = np.abs(j_csv['I']).max()
    assert scale > 0 and np.abs(j_csv['Q']).max() > 1e-3 * scale
    for s in 'IQU':
        np.testing.assert_allclose(csv[s], j_csv[s], rtol=0,
                                   atol=1e-4 * scale, err_msg=s)
    np.testing.assert_allclose(flare['data'], j_flare['data'], rtol=1e-6,
                               atol=1e-6 * np.abs(j_flare['data']).max())
    for k in ('start', 'stop'):
        np.testing.assert_array_equal(flare[k], j_flare[k])
    assert sim['model'] == j_sim['model']
    assert sim['name'] == j_sim['name'] == source
    assert sim['lightcurve_path'] == str(root / 'port' /
                                         f'{source}_lightcurves.csv')


def _recovery_config(path, **optimization):
    raw = yaml.safe_load(fit.CONFIG_PATH.read_text())
    raw['optimization'].update(optimization)
    path.write_text(yaml.dump(raw))
    return path


def test_recovery_config_matches_jax():
    """The port's copy of the recovery configuration is the JAX
    package's."""
    ref = REPO + '/scripts/fit_synthetic_lp_flares.yaml'
    assert yaml.safe_load(fit.CONFIG_PATH.read_text()) == \
        yaml.safe_load(open(ref).read())
    cfg = config.RunConfig.from_yaml(fit.CONFIG_PATH)
    assert cfg.optimization.stokes == ['Q', 'U']
    assert cfg.optimization.fused and cfg.optimization.scan_chunk == 500


@pytest.fixture(scope='module')
def sweep(tmp_path_factory):
    """The port's generator on the hotspot, then the fit script's sweep on
    its data: 2 inclinations x 1 seed, 6 steps in chunks of 3 with logs
    every 3 steps, and the same sweep once more (every run exists)."""
    root = tmp_path_factory.mktemp('sweep')
    with small_traces(), pytest.MonkeyPatch.context() as mp:
        mp.setenv('DRIVE_CPU', '1')
        out = gen.main(GEN_ARGS + ['--out', str(root / 'data'),
                                   '--name', 'hot'])
    cfg_path = _recovery_config(
        root / 'recovery.yaml', scan_chunk=3, log_period=3,
        hparams=dict(num_iters=6, lr_init=1e-3, lr_final=1e-4, seed=1))
    kw = dict(config_path=cfg_path, device='cpu', model_overrides=TRACE,
              verbose=False)
    first = fit.run_sweep(out['yaml'], [40.0, 60.0], [1], MemoryWriter,
                          **kw)
    again = fit.run_sweep(out['yaml'], [40.0, 60.0], [1], MemoryWriter,
                          **kw)
    return dict(root=root, out=out, first=first, again=again, kw=kw)


def test_sweep_trains_and_logs_every_run(sweep):
    """Each run trains 6 steps in its recovery directory and logs the
    flare's truth, the loss every step and, every 3 steps, the volume on
    the flare's grid with its psnr and the training lightcurve fit (Q and
    U); params.yaml records the merge; a second sweep skips every run."""
    recovery_dir = sweep['out']['csv'].parent / 'recovery' / 'hot'
    assert [(r['run'], r['first_step'], r['last_step'])
            for r in sweep['first']] == [('inc_40.0.seed_1', 1, 6),
                                         ('inc_60.0.seed_1', 1, 6)]
    assert sweep['again'] == []
    for r in sweep['first']:
        w = r['writer']
        assert w.logdir == str(recovery_dir / r['run'])
        (step0, truth), = w.volumes['emission/true']
        assert step0 == 0 and truth.shape == (64, 64, 64)
        assert [s for s, _ in w.volumes['emission/estimate']] == [3, 6]
        assert [s for s, _ in w.scalars['log_loss/train']] == \
            list(range(1, 7))
        assert np.isfinite([v for _, v in w.scalars['log_loss/train']]).all()
        assert [s for s, _ in w.scalars['emission/psnr']] == [3, 6]
        (_, lc), _ = w.lightcurves['lightcurve/training']
        assert lc.shape == (len(r['fit']['train']['t']), 2)
        assert 'lightcurve/validation' not in w.lightcurves
        assert state_lib.latest_checkpoint_step(recovery_dir / r['run']) \
            == 6
    params = yaml.safe_load((recovery_dir / 'params.yaml').read_text())
    model = params['recovery']['model']
    assert model['rmax'] == 20.0 and model['recovery_scale'] == 1.0
    assert model['num_alpha'] == 8 and model['z_width'] == 4
    assert params['simulation']['name'] == 'hot'


def test_sweep_split_and_predictor(sweep):
    """The training frames are those up to train_split minutes after
    t_start_obs; the predictor spans the model's domain with posenc_var
    recovery_scale / fov_M; the 'lc' step fits Q and U, fused."""
    f = sweep['first'][0]['fit']
    t = f['train']['t']
    split = f['model_params']['t_start_obs'] + 103.0 / 60.0
    assert len(t) == 34 and t.max() <= split
    assert f['train']['data'].shape == (len(t), 2)
    p = f['predictor']
    assert (p.rmin, p.rmax, p.scale, p.z_width) == \
        (6.0, 20.0, 20.0, 4)
    assert p.posenc_var == 1.0 / 40.0
    opt = sweep['first'][0]['optimizer']
    assert isinstance(opt.raytracing_args[0], step.CompactRayArgs)
    assert opt.raytracing_args[0].num_stokes == 2


def _jax_rts(rts):
    return [j_step.RayTracingArgs(
        **{k: jnp.asarray(getattr(rt, k).numpy()) for k in
           ('coords', 'Omega', 'J', 'g', 'dtau', 'Sigma', 't_geos_rel')},
        t_injection=jnp.zeros((), jnp.float32), t_start_obs=rt.t_start_obs,
        t_to_M=rt.t_to_M, t_units=j_units.hr) for rt in rts]


@pytest.fixture(scope='module')
def dense_rts(sweep):
    """The dense ray constants of the sweep's 60 deg inclination, traced
    again as the sweep traced them."""
    f = sweep['first'][1]['fit']
    params = dict(f['model_params'], **TRACE)
    return alma.get_raytracing_args(np.deg2rad(60.0), 0.0, params,
                                    ['Q', 'U'], device='cpu')


def test_sweep_loss_matches_jax(sweep, dense_rts):
    """The test-mode loss over every training frame of the 60 deg run's
    final params: the port's fused path on its compacted constants against
    the JAX package's TrainStep on the dense ones, rtol 1e-4."""
    r = sweep['first'][1]
    f, opt = r['fit'], r['optimizer']
    loss = total_movie_loss(7, opt.state, f['train']['step'],
                            opt.raytracing_args)
    j_pred = JPredictor(**{k: getattr(f['predictor'], k) for k in (
        'scale', 'rmin', 'rmax', 'z_width', 'posenc_var')})
    state = JTrainState.create(params_to_numpy(opt.params),
                               j_make_optimizer(10))
    j_ts = JTrainStep.image(j_units.Quantity(f['train']['t'], 'hr'),
                            f['train']['data'], j_pred,
                            sigma=np.asarray(0.01), dtype='lc')
    ref = j_total_movie_loss(7, state, j_ts, _jax_rts(dense_rts))
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, ref, rtol=1e-4)


def test_two_row_lc_loss_and_gradients_match_jax(dense_rts):
    """'lc' with Q and U rows through the 'gather' compaction and the
    fused path, with a learnable injection time (the frame-time cotangent
    of the backward): loss rtol 1e-4, gradients atol 1e-4 normalised per
    leaf, d loss / d t_injection rtol 2e-3."""
    kw = dict(scale=20.0, rmin=6.0, rmax=20.0, z_width=4.0, net_depth=4,
              net_width=32, posenc_deg=3, learn_injection=True)
    pred, jpred = NeRFPredictor(**kw), JPredictor(**kw)
    jparams = jpred.init_params(seed=0)
    jparams['dense_4']['bias'] = jparams['dense_4']['bias'] + 8.0
    jparams['t_injection'] = jnp.asarray(0.5, jnp.float32)
    params = pred.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device='cpu')
    crt = step.compact_ensemble_args(dense_rts, pred, layout='gather')[0]
    j_crt = j_step.compact_ensemble_args(_jax_rts(dense_rts), jpred,
                                         tile=fused.TILE_N,
                                         layout='gather')[0]
    assert crt.num_stokes == 2
    target = (0.1 * np.random.default_rng(2).random((3, 2))).astype(
        np.float32)
    sigma = np.full_like(target, 0.01)
    offset = np.zeros_like(target)
    t_M = torch.as_tensor(crt.frame_times_M(np.array([9.4, 9.5, 9.7])),
                          dtype=torch.float32)
    tt = torch.as_tensor
    loss, _ = step.loss_fn_image(params, pred, tt(target), tt(sigma),
                                 tt(offset), t_M, crt, 1.0, 'lc', fused=True)
    loss.backward()
    (ref, _), grads = jax.value_and_grad(
        lambda p: j_step.loss_fn_image(
            p, jpred, jnp.asarray(target), jnp.asarray(sigma),
            jnp.asarray(offset), jnp.asarray(t_M.numpy()), j_crt, 1.0,
            'lc', fused=True), has_aux=True)(jparams)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-4)
    for i, layer in enumerate(params.mlp.layers):
        for got, want in ((layer.weight.grad.numpy(),
                           np.asarray(grads[f'dense_{i}']['kernel']).T),
                          (layer.bias.grad.numpy(),
                           np.asarray(grads[f'dense_{i}']['bias']))):
            scale = np.abs(want).max() + 1e-12
            np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                       atol=1e-4, err_msg=f'layer {i}')
    d_t = float(params.t_injection.grad)
    assert abs(d_t) > 0
    np.testing.assert_allclose(d_t, float(grads['t_injection']), rtol=2e-3)


def test_main_parses_the_reference_arguments(monkeypatch, tmp_path):
    """main() takes the reference script's arguments and hands the sweep
    the simulation's yaml, the inclination grid, the seeds and the
    configuration with the tensorboardX writer."""
    pytest.importorskip('tensorboardX')
    from bhnerf_tpu_torch.train.logging import SummaryWriter
    calls = []
    monkeypatch.setattr(fit, 'run_sweep',
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setenv('DRIVE_CPU', '1')
    fit.main([str(tmp_path / 'sim.yaml'), '4', '1', '--start_inc', '30',
              '--seeds', '2', '5'])
    (args, kw), = calls
    yaml_path, inc_grid, seeds, writer_factory = args
    assert yaml_path == str(tmp_path / 'sim.yaml')
    np.testing.assert_array_equal(inc_grid,
                                  config.inclination_grid([4, 1], 30.0))
    assert seeds == [2, 5] and writer_factory is SummaryWriter
    assert kw == dict(config_path=str(fit.CONFIG_PATH), device='cpu')
