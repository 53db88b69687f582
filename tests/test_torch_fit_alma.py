"""The production ALMA fit of bhnerf_tpu_torch: its configuration, its
logging, the chi-square of trained checkpoints and the fit script's sweep
(counterparts of bhnerf_tpu/config.py, bhnerf_tpu/train/logging.py,
bhnerf_tpu/alma.py:164-247 and scripts/fit_alma_lp_apr11_sgra_flare.py).

The configuration and the chi-square are held against the JAX package;
the sweep runs the port alone on a seeded synthetic observation written
in the data file's format (the flare's data file is not in the
repository), at 8x8 rays of 16 samples traced on the host with few fine
steps, 2 inclinations and a few chunked steps.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from bhnerf_tpu import config as j_config
from bhnerf_tpu import units as j_units
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.train import TrainState as JTrainState
from bhnerf_tpu.train import TrainStep as JTrainStep
from bhnerf_tpu.train import make_optimizer as j_make_optimizer
from bhnerf_tpu.train import step as j_step
from bhnerf_tpu.train import total_movie_loss as j_total_movie_loss
from bhnerf_tpu.train.logging import StepTimer as JStepTimer

import torch

from bhnerf_tpu_torch import alma, config, units
from bhnerf_tpu_torch.models.fields import NeRFPredictor, params_to_numpy
from bhnerf_tpu_torch.parallel import create_mesh
from bhnerf_tpu_torch.scripts import fit_alma_lp_apr11_sgra_flare as fit
from bhnerf_tpu_torch.train import state as state_lib
from bhnerf_tpu_torch.train import step
from bhnerf_tpu_torch.train.logging import MemoryWriter, StepTimer
from bhnerf_tpu_torch.train.optimizer import Optimizer, TrainStep

PRED_KW = dict(scale=8.0, rmax=8.0, z_width=2.0, net_depth=2, net_width=32)
PRED = NeRFPredictor(**PRED_KW)
JPRED = JPredictor(**PRED_KW)
NT = 8
SIGMA = np.array([0.15, 1e-2, 1e-2])
# the host trace of the sweep: 8x8 rays of 16 samples, few fine steps
TRACE = dict(ngeo=16, n_fine=256)


def test_run_config_matches_jax(tmp_path):
    """RunConfig.from_yaml of the fit's configuration equals the JAX
    package's field by field, and to_yaml round-trips it (each package
    reads the other's file the same)."""
    port = config.RunConfig.from_yaml(fit.CONFIG_PATH)
    ref = j_config.RunConfig.from_yaml(fit.CONFIG_PATH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.optimization.scan_chunk == 500 and port.optimization.fused
    assert port.model.resolved_rmin() == ref.model.resolved_rmin()
    port.to_yaml(tmp_path / 'port.yml')
    again = config.RunConfig.from_yaml(tmp_path / 'port.yml')
    assert again == port
    assert dataclasses.asdict(j_config.RunConfig.from_yaml(
        tmp_path / 'port.yml')) == dataclasses.asdict(port)
    with pytest.raises(ValueError, match='unknown config keys'):
        config.RunConfig.from_dict({'model': {'num_rays': 8}})


@pytest.mark.parametrize('inc_args,start_inc', [
    ([60], None), ([4, 1], None), ([4, 1], 30.0), ([20, 3], 12.0),
    ([39, 38], None)])
def test_inclination_grid_matches_jax(inc_args, start_inc):
    np.testing.assert_array_equal(
        config.inclination_grid(inc_args, start_inc),
        j_config.inclination_grid(inc_args, start_inc))


def test_step_timer_matches_jax(monkeypatch):
    """StepTimer: nan until its second step, then steps over seconds; a
    second call at the same step keeps the clock; the same readings as the
    JAX package's timer on the same clock."""
    from bhnerf_tpu_torch.train import logging as port_logging
    clock = iter([10.0, 10.0, 12.0, 12.0, 12.5, 12.5, 14.5, 14.5])
    fake_time = type('Clock', (), {
        'perf_counter': staticmethod(lambda: next(clock))})
    monkeypatch.setattr(port_logging, 'time', fake_time)
    port, ref = StepTimer(), JStepTimer()
    ref._time = fake_time
    readings = []
    for s in (1, 101, 101, 301):
        for timer in (port, ref):
            timer(type('Opt', (), {'step': s})())
        readings.append((port.steps_per_sec, ref.steps_per_sec))
    assert np.isnan(readings[0][0]) and np.isnan(readings[0][1])
    assert readings[1:] == [(50.0, 50.0), (50.0, 50.0), (80.0, 80.0)]


@pytest.fixture(scope='module')
def small_fit():
    """A 4-step chunked fit of a 2-variant polarized ensemble (seeded
    synthetic 8x8x16 tables) on a seeded lightcurve."""
    rng = np.random.default_rng(0)
    shape = (8, 8, 16)
    rts = []
    for _ in range(2):
        fields = dict(
            coords=np.stack([rng.uniform(-7, 7, shape),
                             rng.uniform(-7, 7, shape),
                             rng.uniform(-2.5, 2.5, shape)]),
            Omega=rng.uniform(0.02, 0.08, shape),
            g=rng.uniform(0.5, 1.5, shape), dtau=rng.uniform(0.5, 1.0, shape),
            Sigma=rng.uniform(0.5, 1.0, shape),
            t_geos_rel=rng.uniform(0.0, 50.0, shape),
            J=rng.uniform(-1.0, 1.0, (3, *shape)))
        rts.append({k: v.astype(np.float32) for k, v in fields.items()})
    port_rts = [step.RayTracingArgs(
        **{k: torch.as_tensor(v) for k, v in f.items()},
        t_injection=torch.zeros(()), t_to_M=100.0, t_units=units.hr)
        for f in rts]
    t_hr = np.linspace(0.0, 0.05, NT)
    data = (0.1 * rng.standard_normal((NT, 3))).astype(np.float32)
    train_step = TrainStep.image(units.Quantity(t_hr, 'hr'), data, PRED,
                                 sigma=SIGMA, dtype='lc', fused=True,
                                 device='cpu')
    opt = Optimizer({'num_iters': 4, 'lr_init': 1e-3, 'seed': 2}, PRED,
                    port_rts, device='cpu')
    with torch.no_grad():
        opt.params.mlp.layers[-1].bias += 8.0
    opt.run(4, train_step, port_rts, verbose=False, scan_chunk=2)
    return dict(fields=rts, rts=port_rts, t_hr=t_hr, data=data,
                train_step=train_step, opt=opt)


def _check_writer_tags(writer_tags):
    assert {'emission/estimate', 'lightcurve/training',
            'datafit/training'} <= writer_tags


def test_memory_writer_records_the_closures(small_fit):
    """MemoryWriter keeps the volume, the lightcurve fit and its datafit
    scalar of the log closures, with the optimizer's step."""
    opt = small_fit['opt']
    writer = MemoryWriter()
    writer.recovery_3d(fov=16.0, vis_res=8)(opt)
    writer.plot_lc_datafit(opt, 'training', small_fit['train_step'],
                           small_fit['data'], ['I', 'Q', 'U'],
                           small_fit['t_hr'], batchsize=3)
    _check_writer_tags(set(writer.volumes) | set(writer.lightcurves)
                       | set(writer.scalars))
    (step_v, volume), = writer.volumes['emission/estimate']
    (step_l, lc), = writer.lightcurves['lightcurve/training']
    assert step_v == step_l == 4
    assert volume.shape == (8, 8, 8) and np.isfinite(volume).all()
    assert lc.shape == (NT, 3) and np.isfinite(lc).all()
    (_, datafit), = writer.scalars['datafit/training']
    assert np.isfinite(datafit)


def test_summary_writer_writes_events(tmp_path, small_fit):
    """SummaryWriter on tensorboardX: recovery_3d (against a true volume,
    so with mse and psnr) and plot_lc_datafit write their images, figure
    and scalars into the event file."""
    pytest.importorskip('tensorboardX')
    pytest.importorskip('matplotlib')
    event_accumulator = pytest.importorskip(
        'tensorboard.backend.event_processing.event_accumulator')
    import matplotlib
    matplotlib.use('Agg')
    from bhnerf_tpu_torch import utils
    from bhnerf_tpu_torch.train.logging import SummaryWriter

    opt = small_fit['opt']
    true = utils.Grid3D(torch.rand((6, 6, 6), generator=torch.Generator()
                                   .manual_seed(0)), (-8.0,) * 3, (8.0,) * 3)
    writer = SummaryWriter(logdir=str(tmp_path))
    writer.recovery_3d(fov=16.0, emission_true=true)(opt)
    writer.plot_lc_datafit(opt, 'training', small_fit['train_step'],
                           small_fit['data'], ['I', 'Q', 'U'],
                           small_fit['t_hr'], batchsize=3)
    writer.close()
    events = event_accumulator.EventAccumulator(str(tmp_path))
    events.Reload()
    tags = events.Tags()
    assert {'emission/mse', 'emission/psnr', 'datafit/training'} <= \
        set(tags['scalars'])
    assert any(t.startswith('emission/estimate') for t in tags['images'])
    assert any(t.startswith('lightcurve/training') for t in tags['images'])
    assert events.Scalars('datafit/training')[0].step == 4


def test_summary_writer_needs_tensorboardx(monkeypatch):
    """Without tensorboardX the writer fails when it is made."""
    from bhnerf_tpu_torch.train import logging as port_logging
    monkeypatch.setattr(port_logging, '_HAS_TBX', False)
    with pytest.raises(ImportError, match='tensorboardX'):
        port_logging.SummaryWriter.__init__(object.__new__(
            port_logging.SummaryWriter), logdir='unused')


@pytest.mark.parametrize('rmin,rmax', [(0.0, np.inf), (3.0, 6.0)])
def test_chi2_lightcurves_matches_jax(tmp_path, small_fit, rmin, rmax):
    """chi2_lightcurves of a port checkpoint (the checkpoint's own
    predictor, narrowed to [rmin, rmax]) equals the JAX package's chi^2
    formula (alma.py:193-200) over its test-mode movie of the same
    ensemble with the same params (params_to_numpy), rtol 1e-5."""
    opt = small_fit['opt']
    PRED.save_params(tmp_path)
    state_lib.save_checkpoint(tmp_path, opt.state, 4)
    t_q = units.Quantity(small_fit['t_hr'], 'hr')
    chi2 = alma.chi2_lightcurves(small_fit['rts'], str(tmp_path), t_q,
                                 small_fit['data'], SIGMA, rmin, rmax,
                                 batchsize=3)

    j_pred = dataclasses.replace(JPRED, rmin=max(rmin, JPRED.rmin),
                                 rmax=min(rmax, JPRED.rmax))
    j_rts = [j_step.RayTracingArgs(
        **{k: jnp.asarray(v) for k, v in f.items()},
        t_injection=jnp.zeros((), jnp.float32), t_to_M=100.0,
        t_units=j_units.hr) for f in small_fit['fields']]
    state = JTrainState.create(params_to_numpy(opt.params),
                               j_make_optimizer(10))
    j_ts = JTrainStep.image(j_units.Quantity(small_fit['t_hr'], 'hr'),
                            np.zeros((NT, 3)), j_pred, dtype='lc')
    _, movie = j_total_movie_loss(3, state, j_ts, j_rts, return_frames=True)
    ref = np.sum(((movie.sum(axis=(-1, -2)) - small_fit['data']) / SIGMA)
                 ** 2) / NT
    assert np.isfinite(chi2) and chi2 > 0
    np.testing.assert_allclose(chi2, ref, rtol=1e-5)


def test_chi2_df_backend_and_mesh_refusals():
    """chi2_df refuses a mesh with the host trace (the reference's
    trace_geodesics refuses it) and an unknown backend, before it does
    any work. The device tracer is taken with or without a mesh
    (tests/test_torch_device_geos.py runs it): over a grid without
    checkpoints it traces nothing and leaves every cell NaN."""
    mesh = create_mesh(device='cpu')
    with pytest.raises(ValueError, match='device'):
        alma.chi2_df([60.0], 0.0, [1], {}, '{}-{}', None, None,
                     backend='cpu', mesh=mesh)
    with pytest.raises(ValueError, match='backend'):
        alma.chi2_df([60.0], 0.0, [1], {}, '{}-{}', None, None,
                     backend='tpu')
    for m in (None, mesh):
        df = alma.chi2_df([60.0], 0.0, [1], {}, '{}-{}', None, None,
                          backend='device', mesh=m, device='cpu')
        assert df.shape == (1, 1) and np.isnan(df.values).all()


@pytest.fixture(scope='module')
def sweep(tmp_path_factory):
    """The fit script's sweep on a synthetic observation: 2 inclinations x
    1 seed, 6 chunked steps each (chunks of 3, logs and checkpoints every
    3), then chi2_df over both inclinations, then --resume of the first
    run extended to 9 steps."""
    root = tmp_path_factory.mktemp('fit')
    cfg = config.RunConfig.from_yaml(fit.CONFIG_PATH)
    cfg.preprocess.data_path = fit.write_synthetic_observation(
        root / 'obs.csv')
    cfg.model.num_alpha = cfg.model.num_beta = 8
    opt_cfg = cfg.optimization
    opt_cfg.log_dir, opt_cfg.checkpoint_dir = str(root / 'runs'), \
        str(root / 'ckpt')
    opt_cfg.hparams.num_iters = 6
    opt_cfg.hparams.lr_init = 1e-3
    opt_cfg.scan_chunk = opt_cfg.log_period = opt_cfg.save_period = 3
    kw = dict(device='cpu', model_overrides=TRACE, verbose=False)
    first = fit.run_sweep(cfg, [40.0, 60.0], [1], MemoryWriter, **kw)
    skipped = fit.run_sweep(cfg, [40.0, 60.0], [1], MemoryWriter, **kw)
    listing = {r['run']: state_lib._checkpoint_steps(
        root / 'ckpt' / r['run']) for r in first}
    # chi2 before the resume: both cells read their step-6 fit
    _, train, _ = fit.split_data(cfg, 'cpu')
    df = alma.chi2_df(
        [40.0, 60.0], cfg.model.spin, [1],
        dict(cfg.model.asdict(), **TRACE),
        str(root / 'ckpt' / fit.RUN_NAME), units.Quantity(train['t'], 'hr'),
        train['data'], sigma=np.asarray(opt_cfg.sigma),
        rot_angle=np.deg2rad(cfg.preprocess.de_rot_angle + 20.0),
        checkpoint_name='checkpoint_6', device='cpu')
    opt_cfg.hparams.num_iters = 9
    resumed = fit.run_sweep(cfg, [40.0], [1], MemoryWriter, resume=True,
                            **kw)
    return dict(root=root, cfg=cfg, first=first, skipped=skipped,
                listing=listing, resumed=resumed, df=df, train=train)


def test_sweep_trains_every_cell(sweep):
    """Each (inclination, seed) trains 6 steps in chunks and checkpoints
    at 3 and 6 beside its predictor's yaml; the four LogFns logged the
    per-step training loss and, every 3 steps, the volume and both
    lightcurve fits; a second sweep skips the existing runs."""
    first = sweep['first']
    assert [(r['run'], r['first_step'], r['last_step']) for r in first] == \
        [('inc_40.0.seed_1', 1, 6), ('inc_60.0.seed_1', 1, 6)]
    assert sweep['skipped'] == []
    for r in first:
        assert sweep['listing'][r['run']] == [3, 6]
        assert (sweep['root'] / 'ckpt' / r['run']
                / 'NeRF_Predictor_params.yml').exists()
        writer = r['writer']
        assert [s for s, _ in writer.scalars['log_loss/train']] == \
            list(range(1, 7))
        assert np.isfinite([v for _, v in writer.scalars['log_loss/train']]
                           ).all()
        for name in ('training', 'validation'):
            assert [s for s, _ in writer.scalars[f'datafit/{name}']] == \
                [3, 6]
        assert [s for s, _ in writer.volumes['emission/estimate']] == [3, 6]
    assert (sweep['root'] / 'ckpt' / 'config.yml').exists()
    assert config.RunConfig.from_yaml(sweep['root'] / 'ckpt' /
                                      'config.yml') == sweep['cfg']


def test_sweep_split_matches_the_configuration(sweep):
    """The training frames are those within train_split minutes of
    t_start; the validation frames come after."""
    cfg = sweep['cfg']
    _, train, val = fit.split_data(cfg, 'cpu')
    split = cfg.preprocess.t_start + cfg.optimization.train_split / 60.0
    assert len(train['t']) > 0 and len(val['t']) > 0
    assert train['t'].max() <= split < val['t'].min()
    assert train['data'].shape == (len(train['t']), 3)


def test_resume_continues_from_the_saved_step(sweep):
    """--resume of a finished run extended to 9 steps continues from its
    checkpoint at step 6: its first logged step is 7 and it checkpoints at
    9."""
    (r,) = sweep['resumed']
    assert (r['run'], r['first_step'], r['last_step']) == \
        ('inc_40.0.seed_1', 7, 9)
    assert [s for s, _ in r['writer'].scalars['log_loss/train']] == \
        [7, 8, 9]
    assert state_lib.latest_checkpoint_step(
        sweep['root'] / 'ckpt' / r['run']) == 9


def test_chi2_df_over_the_sweep(sweep):
    """chi2_df over both inclinations: one finite, positive value per
    cell."""
    df = sweep['df']
    assert df.index.name == 'inc' and list(df.index) == [40.0, 60.0]
    assert list(df.columns) == ['seed 1']
    assert np.isfinite(df.values).all() and (df.values > 0).all()


def test_main_parses_the_reference_arguments(monkeypatch, tmp_path):
    """main() takes the reference script's arguments and hands the sweep
    the configuration, the inclination grid, the seeds and the resume flag
    with the tensorboardX writer."""
    pytest.importorskip('tensorboardX')
    from bhnerf_tpu_torch.train.logging import SummaryWriter
    calls = []
    monkeypatch.setattr(fit, 'run_sweep',
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setenv('DRIVE_CPU', '1')
    fit.main(['4', '1', '--start_inc', '30', '--seeds', '2', '5',
              '--data_path', str(tmp_path / 'obs.csv'), '--resume'])
    (args, kw), = calls
    cfg, inc_grid, seeds, writer_factory = args
    assert cfg.preprocess.data_path == str(tmp_path / 'obs.csv')
    np.testing.assert_array_equal(
        inc_grid, j_config.inclination_grid([4, 1], 30.0))
    assert seeds == [2, 5] and writer_factory is SummaryWriter
    assert kw == dict(resume=True, device='cpu')
