"""Port parity of the EHT visibility path: to_real_measurements, the dense
and factored measurement operators, the six interferometric chi-square
losses with their padded rows, TrainStep.eht (multi-pol, composed with a
lightcurve loss, total_movie_loss) and the Optimizer of bhnerf_tpu_torch
against bhnerf_tpu.

The ray constants are a small seeded synthetic table (8x8 rays x 16
samples inside the emission shell), so these tests need no geodesics.
The frames span the ngEHT scan window, 4.0 to 15.5 UT, which is about
2,020 M at Sgr A*'s GM/c^3: the velocity warp reaches Omega * t of about
160 rad. The observation is the EHT2017 array observing a seeded Stokes
movie. The port runs its fused compact path (the kernels' plain versions
on the CPU) with params copied in by params_from_jax. The losses are held
against the reference's plain dense path in float64 (jax.enable_x64): at
this span the reference's plain path in float32 strays from it by up to
5e-6 in the loss and 2e-4 (vis) to 2e-2 (cphase) in the gradients
normalised, while the fused formulation of both packages stays within
1e-4.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bhnerf_tpu import observation as j_observation
from bhnerf_tpu import units as j_units
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.train import LogFn as JLogFn
from bhnerf_tpu.train import Optimizer as JOptimizer
from bhnerf_tpu.train import TrainState as JTrainState
from bhnerf_tpu.train import TrainStep as JTrainStep
from bhnerf_tpu.train import make_optimizer as j_make_optimizer
from bhnerf_tpu.train import step as j_step
from bhnerf_tpu.train import total_movie_loss as j_total_movie_loss

import torch

from bhnerf_tpu_torch import constants, observation, units
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.train import step
from bhnerf_tpu_torch.train.optimizer import (LogFn, Optimizer, TrainStep,
                                              total_movie_loss)
from bhnerf_tpu_torch.train.state import TrainState, make_optimizer

NT = 4
NPIX = 8
PSIZE = 1e-10
FOV_RAD = PSIZE * NPIX
T_HR = np.linspace(4.0, 15.5, NT).astype(np.float32)
T_TO_M = 1.0 / constants.GM_c3(constants.sgra_mass).to('hr').value
PRED_KW = dict(scale=8.0, rmax=8.0, z_width=2.0, net_depth=2, net_width=16)
PRED = NeRFPredictor(**PRED_KW)
JPRED = JPredictor(**PRED_KW)
DTYPES = ('vis', 'amp', 'cphase', 'bs', 'logcamp', 'camp')


def _fields(rng, shape):
    return dict(
        coords=np.stack([rng.uniform(-6, 6, shape), rng.uniform(-6, 6, shape),
                         rng.uniform(-1.5, 1.5, shape)]),
        Omega=rng.uniform(0.02, 0.08, shape), g=rng.uniform(0.5, 1.5, shape),
        dtau=rng.uniform(0.5, 1.0, shape), Sigma=rng.uniform(0.5, 1.0, shape),
        t_geos_rel=rng.uniform(0.0, 50.0, shape))


@pytest.fixture(scope='module')
def problem():
    """Ray constants of both packages (scalar J and 3-Stokes J), the
    reference's initial params with the head lifted, and the EHT2017
    observation of a seeded Stokes movie, made by each package's own
    observation module with thermal noise of seed 0."""
    rng = np.random.default_rng(0)
    shape = (NPIX, NPIX, 16)
    fields = {k: v.astype(np.float32) for k, v in _fields(rng, shape).items()}
    J3 = np.stack([rng.uniform(0.5, 1.0, shape), rng.uniform(-0.5, 0.5, shape),
                   rng.uniform(-0.5, 0.5, shape)]).astype(np.float32)
    out = dict(fields=fields, J={'scalar': 1.0, 'stokes': J3})
    for name, J in out['J'].items():
        rt = step.RayTracingArgs(
            **{k: torch.as_tensor(v) for k, v in fields.items()},
            J=J if np.ndim(J) == 0 else torch.as_tensor(J),
            t_injection=torch.zeros(()), t_start_obs=float(T_HR[0]),
            t_to_M=T_TO_M, t_units=units.hr)
        out[name] = step.compact_raytracing_args(rt, PRED, layout='gather')
        out['j_' + name] = j_ray_args(out, name, jnp.float32)
    jparams = jax.tree_util.tree_map(np.asarray, JPRED.init_params(seed=0))
    jparams[f'dense_{PRED.net_depth}']['bias'] = \
        jparams[f'dense_{PRED.net_depth}']['bias'] + 8.0
    movie = rng.random((NT, 3, NPIX, NPIX))
    movie[:, 1:] -= 0.5
    for name, lib in (('obs', observation), ('j_obs', j_observation)):
        array = lib.load_txt('eht_arrays/EHT2017.txt')
        empty = lib.empty_eht_obs(array, nt=8, tint=60.0)
        out[name] = lib.observe_same(movie, T_HR, PSIZE, empty,
                                     thermal_noise=True, seed=0)
    out.update(jparams=jparams, movie=movie)
    return out


def j_ray_args(problem, name, dtype):
    """The reference's dense ray constants `name` in `dtype` (float64 only
    under jax.enable_x64)."""
    J = problem['J'][name]
    return j_step.RayTracingArgs(
        **{k: jnp.asarray(v, dtype) for k, v in problem['fields'].items()},
        J=J if np.ndim(J) == 0 else jnp.asarray(J, dtype),
        t_injection=jnp.zeros((), dtype), t_start_obs=float(T_HR[0]),
        t_to_M=T_TO_M, t_units=j_units.hr)


def torch_params(problem):
    return PRED.params_from_jax(problem['jparams'], device='cpu')


def measurements(problem, dtype, operator='dense', pol='I'):
    """(target, sigma, A) of the port's observation, split into re/im."""
    data = problem['obs'].chisqdata(T_HR, dtype, FOV_RAD, NPIX, pol=pol,
                                    operator=operator)
    return step.to_real_measurements(dtype, *data)


CASES = [(d, op, 'I') for d in DTYPES for op in ('dense', 'factored')] + \
    [(d, op, ['I', 'Q', 'U']) for d in ('vis', 'amp')
     for op in ('dense', 'factored')]


@pytest.mark.parametrize('dtype,operator,pol', CASES)
def test_to_real_measurements_exact(problem, dtype, operator, pol):
    """The split into re/im is the reference's, bit for bit."""
    data = problem['obs'].chisqdata(T_HR, dtype, FOV_RAD, NPIX, pol=pol,
                                    operator=operator)
    ours = step.to_real_measurements(dtype, *data)
    ref = j_step.to_real_measurements(dtype, *data)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _operator(rng, operator, nvis, nx, ny, lead):
    """A seeded operator over `nvis` uv points for (ny, nx) images, split
    into re/im and broadcast over the leading dims `lead`."""
    u, v = rng.uniform(-5e9, 5e9, (2, nvis))
    kw = dict(image_fov_y=PSIZE * ny, image_size_y=ny)
    if operator == 'dense':
        A = observation.dft_matrix(u, v, PSIZE * nx, nx, **kw)
        A = np.stack([A.real, A.imag])
    else:
        A = observation.dft_factors(u, v, PSIZE * nx, nx, **kw)
    return np.broadcast_to(A, (*lead, *A.shape)).astype(np.float32)


@pytest.mark.parametrize('operator', ['dense', 'factored'])
@pytest.mark.parametrize('ny,nx', [(8, 8), (6, 10)])
@pytest.mark.parametrize('npol', [1, 3])
def test_apply_measurement_operator_matches_jax(operator, ny, nx, npol):
    """Visibilities and the images' cotangent (the product's adjoint)
    against the reference's product and jax.vjp: rtol 1e-5, atol 1e-5 of
    the largest entry (entries near zero come out of sums that cancel)."""
    rng = np.random.default_rng(1)
    lead = (3,) if npol == 1 else (3, npol)
    images = rng.random((*lead, ny, nx)).astype(np.float32)
    A = _operator(rng, operator, 7, nx, ny, lead)
    g = rng.standard_normal((*lead, 2, 7)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: j_step.apply_measurement_operator(
        x, jnp.asarray(A)), jnp.asarray(images))
    ref_grad = np.asarray(vjp(jnp.asarray(g))[0])
    x = torch.as_tensor(images).requires_grad_()
    out = step.apply_measurement_operator(x, torch.as_tensor(A))
    out.backward(torch.as_tensor(g))
    for a, b in ((out.detach().numpy(), np.asarray(ref)),
                 (x.grad.numpy(), ref_grad)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def test_apply_measurement_operator_refuses_other_shapes():
    images = torch.zeros((2, 8, 8))
    for shape in ((2, 2, 5, 60), (2, 4, 5, 6)):
        with pytest.raises(ValueError, match='matches neither'):
            step.apply_measurement_operator(images, torch.zeros(shape))


def _losses(problem, dtype, data):
    """Loss and parameter gradients of both packages on the same
    measurements: the port's fused compact path in float32, the
    reference's plain dense path in float64 on the same float32 inputs.
    Returns ((loss, grads), (j_loss, j_grads)), gradients as (in, out)
    kernels and biases in layer order."""
    params = torch_params(problem)
    crt = problem['scalar']
    loss, _ = step.loss_fn_eht(
        params, PRED, *(torch.as_tensor(x) for x in data),
        crt.frame_times_M(torch.as_tensor(T_HR)), crt, 1.0, dtype,
        fused=True)
    loss.backward()
    grads = [g for layer in params.mlp.layers
             for g in (layer.weight.grad.numpy().T, layer.bias.grad.numpy())]
    with jax.enable_x64(True):
        f64 = lambda x: jnp.asarray(x, jnp.float64)
        j_rt = j_ray_args(problem, 'scalar', jnp.float64)

        def j_loss_fn(p):
            return j_step.loss_fn_eht(
                p, JPRED, *(f64(x) for x in data),
                j_rt.frame_times_M(f64(T_HR)), j_rt, 1.0, dtype,
                fused=False)[0]

        j_loss, j_grads = jax.jit(jax.value_and_grad(j_loss_fn))(
            jax.tree_util.tree_map(f64, problem['jparams']))
        j_grads = [np.asarray(j_grads[f'dense_{i}'][k])
                   for i in range(len(params.mlp.layers))
                   for k in ('kernel', 'bias')]
    return (float(loss.detach()), grads), (float(j_loss), j_grads)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('operator', ['dense', 'factored'])
def test_loss_fn_eht_matches_jax(problem, dtype, operator):
    """Every chi-square against the reference (float64) at the same
    params: value rtol 1e-4, every parameter gradient atol 1e-4 after
    normalising by its largest entry (test_torch_train.py's image-loss
    tolerance). The frames' padded rows are part of the data."""
    data = measurements(problem, dtype, operator)
    (loss, grads), (j_loss, j_grads) = _losses(problem, dtype, data)
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, j_loss, rtol=1e-4)
    for a, b in zip(grads, j_grads):
        assert np.isfinite(a).all()
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)


@pytest.mark.parametrize('dtype', ['cphase', 'logcamp', 'camp'])
def test_padded_rows_are_inert(problem, dtype):
    """Rows with A = 0 and sigma = inf (tests/test_review_regressions.py:
    80-112): the loss and every gradient finite and equal to those without
    the padded row (rtol 1e-6: the sums run over one more zero), and the
    same as the reference's (float64)."""
    legs = 3 if dtype == 'cphase' else 4
    nrow = 3
    A = np.zeros((NT, legs, 2, nrow, NPIX * NPIX), np.float32)
    A[..., :2, :] = np.random.default_rng(2).uniform(
        -0.2, 1.0, (NT, legs, 2, 2, NPIX * NPIX))
    target = np.full((NT, nrow), 0.3, np.float32)
    sigma = np.broadcast_to(np.where(np.arange(nrow) < 2, 1.0, np.inf),
                            (NT, nrow)).astype(np.float32)
    padded, ref = _losses(problem, dtype, (target, sigma, A))
    rows = slice(0, 2)
    trimmed, _ = _losses(problem, dtype, (target[:, rows], sigma[:, rows],
                                          A[..., rows, :]))
    assert np.isfinite(padded[0])
    np.testing.assert_allclose(padded[0], trimmed[0], rtol=1e-6)
    np.testing.assert_allclose(padded[0], ref[0], rtol=1e-4)
    for a, b, c in zip(padded[1], trimmed[1], ref[1]):
        assert np.isfinite(a).all()
        scale = np.abs(c).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a / scale, c / scale, atol=1e-4)


def test_emission_over_the_ngeht_span(problem):
    """Images of the port's fused compact path against the reference's
    plain dense path at frames spread over the 11.5-hr scan window,
    scalar and 3-Stokes J: atol 2e-5 after normalising by the max (the
    tolerance of test_torch_train.py's compact-against-dense test)."""
    t_hr = np.linspace(4.0, 15.5, 6).astype(np.float32)
    assert (t_hr[-1] - t_hr[0]) * T_TO_M > 2000.0
    for name in ('scalar', 'stokes'):
        crt, j_rt = problem[name], problem['j_' + name]
        with torch.no_grad():
            img = step.image_plane_prediction(
                torch_params(problem), PRED,
                crt.frame_times_M(torch.as_tensor(t_hr)), crt,
                fused=True).numpy()
        ref = np.asarray(jax.jit(lambda p: j_step.image_plane_prediction(
            p, JPRED, j_rt.frame_times_M(jnp.asarray(t_hr)), j_rt,
            fused=False))(problem['jparams']))
        assert img.shape == ref.shape
        scale = np.abs(ref).max()
        np.testing.assert_allclose(img / scale, ref / scale, atol=2e-5)
        # the frames differ: the warp moves the field between them
        assert np.abs(ref[0] - ref[-1]).max() > 0.05 * scale


def _states(problem, num_iters=10):
    """A port TrainState and a reference TrainState on the same params."""
    state = TrainState.create(torch_params(problem),
                              make_optimizer(num_iters, lr_init=1e-3))
    j_state = JTrainState.create(problem['jparams'], j_make_optimizer(
        num_iters, lr_init=1e-3))
    return state, j_state


def test_multipol_eht_step_matches_jax(problem):
    """pol=['I','Q','U'] against 3-Stokes ray constants: each pol's
    operator acts on its Stokes image (tests/test_workflow_coverage.py:
    52-70). A test step's loss (rtol 1e-4) and images (atol 2e-5 of the
    max) as the reference's; then a gradient step's loss, and the test
    loss falls after 10 steps."""
    t_q = units.Quantity(T_HR, 'hr')
    ours = TrainStep.eht(t_q, problem['obs'], FOV_RAD, NPIX, PRED,
                         dtype='vis', pol=['I', 'Q', 'U'], fused=True,
                         device='cpu')
    ref = JTrainStep.eht(j_units.Quantity(T_HR, 'hr'), problem['j_obs'],
                         FOV_RAD, NPIX, JPRED, dtype='vis',
                         pol=['I', 'Q', 'U'])
    state, j_state = _states(problem)
    idx = np.arange(NT)
    loss0, _, images = ours(state, problem['stokes'], idx,
                            update_state=False)
    j_loss0, _, j_images = ref(j_state, problem['j_stokes'], idx,
                               update_state=False)
    assert tuple(images.shape) == (NT, 3, NPIX, NPIX)
    np.testing.assert_allclose(float(loss0), float(j_loss0), rtol=1e-4)
    scale = np.abs(np.asarray(j_images)).max()
    np.testing.assert_allclose(images.numpy() / scale,
                               np.asarray(j_images) / scale, atol=2e-5)
    loss1, state, _ = ours(state, problem['stokes'], idx)
    j_loss1, j_state, _ = ref(j_state, problem['j_stokes'], idx)
    np.testing.assert_allclose(float(loss1), float(j_loss1), rtol=1e-4)
    for _ in range(9):
        ours(state, problem['stokes'], idx)
    after = float(ours(state, problem['stokes'], idx, update_state=False)[0])
    assert after < float(loss0)


def test_composed_lc_and_eht_step_matches_jax(problem):
    """step_lc + step_eht (tests/test_workflow_coverage.py:96-99): the
    test loss and a gradient step's loss as the reference's (rtol 1e-4)
    and one Adam update per loss."""
    lc = problem['movie'].sum(axis=(-1, -2)).astype(np.float32)
    t_q, j_t_q = units.Quantity(T_HR, 'hr'), j_units.Quantity(T_HR, 'hr')
    ours = TrainStep.image(t_q, lc, PRED, dtype='lc', fused=True,
                           device='cpu') + \
        TrainStep.eht(t_q, problem['obs'], FOV_RAD, NPIX, PRED, dtype='vis',
                      scale=0.5, pol=['I', 'Q', 'U'], fused=True,
                      device='cpu')
    ref = JTrainStep.image(j_t_q, lc, JPRED, dtype='lc') + \
        JTrainStep.eht(j_t_q, problem['j_obs'], FOV_RAD, NPIX, JPRED,
                       dtype='vis', scale=0.5, pol=['I', 'Q', 'U'])
    assert ours.num_losses == ref.num_losses == 2
    state, j_state = _states(problem)
    idx = np.arange(NT)
    for update in (False, True):
        loss, state, _ = ours(state, problem['stokes'], idx,
                              update_state=update)
        j_loss, j_state, _ = ref(j_state, problem['j_stokes'], idx,
                                 update_state=update)
        assert np.isfinite(float(loss))
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    assert state.step == int(np.asarray(j_state.step)) == 2


def test_total_movie_loss_returns_eht_frames(problem):
    """total_movie_loss over an EHT step in chunks of 3 frames: the loss
    (rtol 1e-4) and the frames (atol 2e-5 of the max) as the
    reference's."""
    t_q = units.Quantity(T_HR, 'hr')
    ours = TrainStep.eht(t_q, problem['obs'], FOV_RAD, NPIX, PRED,
                         dtype='amp', fused=True, device='cpu')
    ref = JTrainStep.eht(j_units.Quantity(T_HR, 'hr'), problem['j_obs'],
                         FOV_RAD, NPIX, JPRED, dtype='amp')
    state, j_state = _states(problem)
    loss, frames = total_movie_loss(3, state, ours, problem['scalar'],
                                    return_frames=True)
    j_loss, j_frames = j_total_movie_loss(3, j_state, ref,
                                          problem['j_scalar'],
                                          return_frames=True)
    assert frames.shape == np.asarray(j_frames).shape == (NT, NPIX, NPIX)
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-4)
    scale = np.abs(np.asarray(j_frames)).max()
    np.testing.assert_allclose(frames / scale, np.asarray(j_frames) / scale,
                               atol=2e-5)


@pytest.mark.parametrize('operator', ['dense', 'factored'])
def test_optimizer_matches_jax(problem, operator):
    """The reference's Optimizer and the port's, 10 steps of TrainStep.eht
    ('vis') with a batch of every frame (so the frame draws do not
    matter) from the same params: the same loss series (rtol 2e-4) and
    params within atol 1e-3 of the most a parameter can move in 10 updates
    (the Adam tolerance of test_torch_checkpoint.py); every layer moved by
    more than 10x that."""
    hparams = {'num_iters': 10, 'lr_init': 1e-3, 'lr_final': 1e-5, 'seed': 0}
    t_q = units.Quantity(T_HR, 'hr')
    ours = TrainStep.eht(t_q, problem['obs'], FOV_RAD, NPIX, PRED,
                         dtype='vis', fused=True, operator=operator,
                         device='cpu')
    ref = JTrainStep.eht(j_units.Quantity(T_HR, 'hr'), problem['j_obs'],
                         FOV_RAD, NPIX, JPRED, dtype='vis', operator=operator)
    j_opt = JOptimizer(hparams, JPRED, problem['j_scalar'])
    j_opt.state = JTrainState(j_opt.state.step, problem['jparams'],
                              j_opt.state.opt_state, j_opt.state.tx)
    opt = Optimizer(hparams, PRED, problem['scalar'], device='cpu')
    with torch.no_grad():
        opt.state.params.load_state_dict(torch_params(problem).state_dict())
    start = {k: v.clone() for k, v in opt.params.state_dict().items()}
    seen = {'jax': [], 'torch': []}
    j_opt.run(NT, ref, problem['j_scalar'], verbose=False,
              log_fns=[JLogFn(lambda o: seen['jax'].append(float(o.loss)))])
    opt.run(NT, ours, problem['scalar'], verbose=False,
            log_fns=[LogFn(lambda o: seen['torch'].append(float(o.loss)))])
    assert len(seen['torch']) == len(seen['jax']) == 10
    np.testing.assert_allclose(seen['torch'], seen['jax'], rtol=2e-4)
    assert seen['torch'][-1] < seen['torch'][0]
    atol = 1e-3 * sum(opt.state.tx.lr(k) for k in range(10))
    j_params = jax.tree_util.tree_map(np.asarray, j_opt.params)
    for i, layer in enumerate(opt.params.mlp.layers):
        jp = j_params[f'dense_{i}']
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   jp['kernel'].T, rtol=0, atol=atol)
        np.testing.assert_allclose(layer.bias.detach().numpy(), jp['bias'],
                                   rtol=0, atol=atol)
        moved = float((layer.weight.detach()
                       - start[f'mlp.layers.{i}.weight']).abs().max())
        assert moved > 10 * atol, f'layer {i} did not move'
