"""The lightcurve examples of bhnerf_tpu_torch against bhnerf_tpu:
alma_synthetic_flare (examples/alma_synthetic_flare.py) and
polarized_lightcurve_recovery (examples/polarized_lightcurve_recovery.py).

Both examples trace at trace_geodesics' defaults, which the port's host
loop cannot afford here: every trace of both packages is forced to 16
samples a ray and 256 fine steps (TRACE) for the call. Tolerances:
synthesize_alma_csv's times exactly and its I, Q and U within 1e-4 of the
largest |I| (the two packages' tables differ in their float32 / float64
traces); the Q/U example's lightcurve within 1e-4 of its largest |value|;
its first 20 losses, from the JAX package's params on the same ray
constants and frame batches, rtol 1e-3 (Adam's normalised steps carry the
kernels' float32 round-off forward); the production fit's 200 steps as
its test states. Both --small runs go end to end on
the host in tests/test_torch_lightcurve_examples_small.py.
"""
import contextlib
import importlib.util
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bhnerf_tpu import units as j_units
from bhnerf_tpu.geodesics import dataset as j_dataset
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.train import TrainState as JTrainState
from bhnerf_tpu.train import TrainStep as JTrainStep
from bhnerf_tpu.train import make_optimizer as j_make_optimizer
from bhnerf_tpu.train import step as j_step

import torch

from bhnerf_tpu_torch import alma
from bhnerf_tpu_torch.examples import alma_synthetic_flare as flare
from bhnerf_tpu_torch.examples import polarized_lightcurve_recovery as qu
from bhnerf_tpu_torch.geodesics import dataset
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.ops import fused
from bhnerf_tpu_torch.train import raytracing_args
from _torch_cores import cores_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = dict(ngeo=16, n_fine=256)


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


def _reference_example(name):
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f'reference_{name}', os.path.join(REPO, 'examples', f'{name}.py'))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    finally:
        sys.path[:] = path


def test_synthesize_alma_csv_matches_jax(tmp_path):
    """The rendered, normalised, re-rotated and noised lightcurve at 8x8
    rays over 9.33-9.47 h: 128 frames at 4 s cadence, rendered in two
    blocks of 64."""
    import pandas as pd
    rot = np.deg2rad(32.2 + 20.0)
    kw = dict(t_end=9.4718, num=8, rot_angle=rot)
    with small_traces():
        params = flare.synthesize_alma_csv(tmp_path / 'port.csv',
                                           device='cpu', **kw)
        j_params = _reference_example('alma_synthetic_flare') \
            .synthesize_alma_csv(tmp_path / 'jax.csv', **kw)
    assert params == j_params
    port, ref = (pd.read_csv(tmp_path / f'{s}.csv') for s in ('port', 'jax'))
    assert list(port.columns) == list(ref.columns) == ['Unnamed: 0', 'time',
                                                       'I', 'Q', 'U']
    assert len(port) == 128
    np.testing.assert_array_equal(port['time'], ref['time'])
    scale = np.abs(ref['I']).max()
    np.testing.assert_allclose(port['I'].mean(), 2.4, rtol=1e-6)
    for s in 'IQU':
        np.testing.assert_allclose(port[s], ref[s], rtol=0,
                                   atol=1e-4 * scale, err_msg=s)


@pytest.fixture(scope='module')
def qu_data():
    """The Q/U example's hotspot lightcurves at 8x8 rays and 8 frames."""
    with small_traces():
        return qu.hotspot_lightcurves(8, 8, 32, device='cpu')


def _jax_rt(rt):
    return j_step.RayTracingArgs(
        **{k: jnp.asarray(getattr(rt, k).numpy()) for k in
           ('coords', 'Omega', 'J', 'g', 'dtau', 'Sigma', 't_geos_rel')},
        t_injection=jnp.zeros((), jnp.float32), t_start_obs=rt.t_start_obs,
        t_to_M=rt.t_to_M, t_units=j_units.hr)


def test_qu_lightcurve_matches_jax(qu_data):
    """The hotspot's I, Q, U lightcurve at 60 deg against the JAX
    package's render of its own table at the same sizes."""
    from bhnerf_tpu import alma as j_alma
    from bhnerf_tpu import emission as j_emission
    model = dict(qu.MODEL, num_alpha=8, num_beta=8)
    with small_traces():
        geos, Omega, J = j_alma.image_plane_model(qu.INC_TRUE, 0.0, model)
    hotspot = j_emission.generate_hotspot((32,) * 3, [0, 0, 1], 0.0, 8.0,
                                          1.0, 6.0, qu.FOV)
    t_frames = j_units.Quantity(np.linspace(9.34, 10.4, 8), 'hr')
    movie = np.asarray(j_emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, -float(geos.r_o + 7.5), J=J,
        t_start_obs=t_frames[0]))
    ref = movie.sum(axis=(-1, -2))
    lc = qu_data['lc']
    assert lc.shape == ref.shape == (8, 3)
    scale = np.abs(ref).max()
    assert np.abs(ref[:, 1:3]).max() > 0.05 * scale
    np.testing.assert_allclose(lc, ref, rtol=0, atol=1e-4 * scale)


def test_qu_fit_losses_match_jax(qu_data):
    """The first 20 'lc' losses of the Q/U fit (fused, compacted, lr 1e-3
    -> 1e-5) from the JAX package's seed-1 params on the same ray
    constants and frame batches."""
    data = qu_data
    jpred = JPredictor(**qu.PREDICTOR)
    jparams = jpred.init_params(seed=1)
    port_params = NeRFPredictor(**qu.PREDICTOR).params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device='cpu')
    rng = np.random.default_rng(0)
    indices = [np.sort(rng.choice(8, qu.BATCH, replace=False))
               for _ in range(20)]
    fit = qu.fit_qu(data, 20, device='cpu', params=port_params,
                    indices=[torch.as_tensor(i) for i in indices])

    rt = raytracing_args(data['geos'], data['Omega'], data['t_injection'],
                         data['t_frames'][0], J=data['J'][1:3], device='cpu')
    j_crt = j_step.compact_raytracing_args(_jax_rt(rt), jpred,
                                           tile=fused.TILE_N)
    step = JTrainStep.image(data['t_frames'], data['lc'][:, 1:3], jpred,
                            sigma=qu.SIGMA, dtype='lc', fused=True)
    state = JTrainState.create(jparams, j_make_optimizer(20, lr_init=1e-3,
                                                         lr_final=1e-5))
    ref = []
    for inds in indices:
        loss, state, _ = step(state, j_crt, inds)
        ref.append(float(loss))
    assert np.isfinite(fit['losses']).all()
    assert ref[-1] < ref[0]
    np.testing.assert_allclose(fit['losses'], ref, rtol=1e-3)


def test_production_lc_fit_tracks_jax(tmp_path):
    """The production drive's fit, 200 'lc' steps on its lightcurve (the
    seeded Apr11-like file, preprocessed by the fit's configuration) at
    its schedule (lr 1e-4 -> 1e-6 over 50,000 steps) and predictor, on a
    seeded 8x8x16 table with I, Q and U weights: from the JAX package's
    seed-4 params and the same frame batches, the port's loss series
    (fused, compacted) tracks the JAX package's (its XLA path, on the
    table it compacted itself): its first 20 steps within rtol 1e-5, all
    200 within rtol 1e-2 with a median relative difference below 1e-3;
    and the loss falls."""
    import dataclasses

    from bhnerf_tpu_torch import config
    from bhnerf_tpu_torch.scripts import drive_alma_production as prod
    from bhnerf_tpu_torch.scripts import fit_alma_lp_apr11_sgra_flare as fit
    from bhnerf_tpu_torch.train import TrainState, make_optimizer
    from bhnerf_tpu_torch.train import step

    csv = tmp_path / 'apr11.csv'
    prod.make_synthetic_csv(csv)
    cfg = config.RunConfig.from_yaml(fit.CONFIG_PATH)
    cfg.preprocess.data_path = str(csv)
    target, t_frames = alma.preprocess_data(
        **dataclasses.asdict(cfg.preprocess))
    target = target.astype(np.float32)
    t_hr = np.asarray(t_frames.value, np.float32)
    rng = np.random.default_rng(0)
    shape = (8, 8, 16)
    x, y = rng.uniform(-20, 20, (2, *shape))
    I = rng.uniform(0.5, 1.5, shape)
    chi = 0.5 * np.arctan2(y, x)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    rt = step.RayTracingArgs(
        coords=f32(np.stack([x, y, rng.uniform(-6, 6, shape)])),
        Omega=f32(rng.uniform(0.005, 0.07, shape)),
        J=f32(np.stack([I, 0.3 * I * np.cos(2 * chi),
                        0.3 * I * np.sin(2 * chi)])),
        g=f32(rng.uniform(0.5, 1.5, shape)),
        dtau=f32(rng.uniform(0.001, 0.002, shape)),
        Sigma=f32(rng.uniform(10, 100, shape)),
        t_geos_rel=f32(rng.uniform(0, 50, shape)), t_injection=f32(0.0),
        t_start_obs=cfg.model.t_start_obs, t_to_M=100.0, t_units=j_units.hr)
    rmax = cfg.model.fov_M / 2
    kw = dict(scale=rmax, rmin=cfg.model.resolved_rmin(), rmax=rmax,
              z_width=cfg.model.z_width)
    pred, jpred = NeRFPredictor(**kw), JPredictor(**kw)
    crt = step.compact_raytracing_args(rt, pred, layout='gather')
    j_crt = j_step.compact_raytracing_args(_jax_rt(rt), jpred,
                                           tile=fused.TILE_N, layout='gather')
    sigma = np.broadcast_to(np.asarray(cfg.optimization.sigma, np.float32),
                            target.shape).copy()
    offset = np.zeros_like(target)
    hp = cfg.optimization.hparams
    jparams = jpred.init_params(seed=hp.seed)
    indices = [rng.choice(len(t_hr), cfg.optimization.batchsize,
                          replace=False) for _ in range(200)]

    j_state = JTrainState.create(jparams, j_make_optimizer(
        hp.num_iters, hp.lr_init, hp.lr_final))
    j_grad, _ = j_step.make_step_fns(jpred, kind='image', dtype='lc',
                                     fused=False, gather=True)
    state = TrainState.create(
        pred.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device='cpu'),
        make_optimizer(hp.num_iters, hp.lr_init, hp.lr_final))
    grad, _ = step.make_step_fns(pred, dtype='lc', fused=True)
    tt = torch.as_tensor
    ref, got = [], []
    for idx in indices:
        loss, j_state, _ = j_grad(
            j_state, jnp.asarray(target), jnp.asarray(sigma),
            jnp.asarray(offset), jnp.asarray(t_hr),
            jnp.asarray(idx, jnp.int32), j_crt, 1.0)
        ref.append(float(loss))
        loss, state, _ = grad(state, tt(target), tt(sigma), tt(offset),
                              tt(t_hr), tt(idx), crt, 1.0)
        got.append(float(loss))
    assert np.mean(ref[-20:]) < np.mean(ref[:20])
    # the packages' posenc differ by ~1e-6 (the kernels' double-angle
    # recursion against XLA's sin); Adam's sign-like first steps carry
    # that forward, so the series part slowly
    rel = np.abs(np.subtract(got, ref)) / np.abs(ref)
    np.testing.assert_allclose(got[:20], ref[:20], rtol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-2)
    assert np.median(rel) < 1e-3, np.median(rel)
