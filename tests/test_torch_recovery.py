"""Port parity for the recovery workflow: a synthetic hotspot, its
ground-truth movie, a short fit and the 3D volume PSNR, in
bhnerf_tpu_torch against bhnerf_tpu; and the repairs of the port's
scalar Stokes factor, its 'auto' layout and the kernels' width padding.

Small sizes: one 8x8x32 geodesic table traced once (n_fine 1024), a 16^3
hotspot, 8 frames over an hour, a 4x32 MLP. Inputs come from numpy
seeds; JAX parameters are copied in with params_from_jax and frame
indices are passed explicitly. On the CPU the fused path runs the
kernels' plain versions.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bhnerf_tpu import constants as j_consts
from bhnerf_tpu import emission as j_emission
from bhnerf_tpu import units as j_units
from bhnerf_tpu import utils as j_utils
from bhnerf_tpu.geodesics import image_plane_geos
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.models import sample_3d_grid as j_sample_3d_grid
from bhnerf_tpu.train import TrainState as JTrainState
from bhnerf_tpu.train import TrainStep as JTrainStep
from bhnerf_tpu.train import make_optimizer as j_make_optimizer
from bhnerf_tpu.train import raytracing_args as j_raytracing_args
from bhnerf_tpu.train import step as j_step

import torch

from bhnerf_tpu_torch import emission, units, utils
from bhnerf_tpu_torch.geodesics.dataset import Geodesics
from bhnerf_tpu_torch.models.fields import (NeRFPredictor, params_to_numpy,
                                            sample_3d_grid)
from bhnerf_tpu_torch.ops import fused
from bhnerf_tpu_torch.train import step
from bhnerf_tpu_torch.train.optimizer import TrainStep
from bhnerf_tpu_torch.train.state import TrainState, make_optimizer

SPIN, FOV, NT, RES = 0.2, 16.0, 8, 16
PRED_KW = dict(scale=FOV / 2, rmin=0.0, rmax=FOV / 2, z_width=2.0,
               net_depth=4, net_width=32, posenc_deg=3)
TILE = fused.TILE_N


@pytest.fixture(scope='module')
def setup():
    geos = image_plane_geos(spin=SPIN, inclination=np.deg2rad(60),
                            alpha_range=(-FOV / 2, FOV / 2),
                            beta_range=(-FOV / 2, FOV / 2), ngeo=32,
                            num_alpha=8, num_beta=8, n_fine=1024)
    tgeos = Geodesics(**{f: np.asarray(getattr(geos, f))
                         for f in Geodesics._FIELDS + Geodesics._AUX})
    r_isco = float(j_consts.isco_pro(SPIN))
    hot_kw = dict(resolution=(RES,) * 3, rot_axis=[0, 0, 1], rot_angle=0.0,
                  orbit_radius=1.1 * r_isco, std=0.7, r_isco=r_isco, fov=FOV)
    t_hr = np.linspace(0.0, 1.0, NT)
    t_inj = -float(geos.r_o + FOV / 4)
    j_hot = j_emission.generate_hotspot(**hot_kw)
    hot = emission.generate_hotspot(**hot_kw)
    j_movie = np.asarray(j_emission.image_plane_dynamics(
        j_hot, geos, geos.keplerian_omega(), j_units.Quantity(t_hr, 'hr'),
        t_inj))
    return dict(geos=geos, tgeos=tgeos, r_isco=r_isco, hot_kw=hot_kw,
                t_hr=t_hr, t_inj=t_inj, j_hot=j_hot, hot=hot,
                j_movie=j_movie)


def render(s, emission_0=None, **kw):
    """The port's movie of the setup's hotspot (or `emission_0`) on the
    CPU."""
    return emission.image_plane_dynamics(
        s['hot'] if emission_0 is None else emission_0, s['tgeos'],
        s['tgeos'].keplerian_omega(), units.Quantity(s['t_hr'], 'hr'),
        s['t_inj'], device='cpu', **kw).numpy()


def j_render(s, emission_0=None, **kw):
    return np.asarray(j_emission.image_plane_dynamics(
        s['j_hot'] if emission_0 is None else emission_0, s['geos'],
        s['geos'].keplerian_omega(), j_units.Quantity(s['t_hr'], 'hr'),
        s['t_inj'], **kw))


def assert_movie_close(out, ref):
    """The port's time arithmetic is float64 on the host and its Doppler
    factor float64; the reference's both float32 (t_geos near -1000 M):
    atol 5e-5 of the movie's max."""
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(out / scale, ref / scale, atol=5e-5, rtol=0)


# ---------------------------------------------------------------------------
# utils and synthetic emission
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('dims', [2, 3])
def test_gaussian_field_matches_jax(dims):
    """gaussian_field is the reference's float64 numpy cast to float32:
    data exactly; the trapezoid integral in float32, rtol 1e-6."""
    center = [1.5, -2.0, 0.5][:dims]
    ref = j_utils.gaussian_field((12, 10, 8)[:dims], center, 1.3, fov=8.0,
                                 std_clip=2.5)
    out = utils.gaussian_field((12, 10, 8)[:dims], center, 1.3, fov=8.0,
                               std_clip=2.5)
    assert out.data.dtype == torch.float32
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(ref.data))
    assert out.spatial_shape == ref.spatial_shape and out.fov == ref.fov
    np.testing.assert_allclose(float(out.integrate()),
                               float(ref.integrate()), rtol=1e-6)
    np.testing.assert_allclose(out.coord_1d(0), ref.coord_1d(0), rtol=0)
    np.testing.assert_array_equal((out * 2.0).data.numpy(),
                                  np.asarray((ref * 2.0).data))
    np.testing.assert_array_equal((out / 4.0).data.numpy(),
                                  np.asarray((ref / 4.0).data))


@pytest.mark.parametrize('resolution,rot_axis', [
    ((16, 16), [0, 0, 1]), ((16, 16, 16), [0, 0, 1]),
    ((12, 14, 10), [0.3, -0.2, 1.0])], ids=['2d', '3d', '3d-tilted'])
def test_generate_hotspot_matches_jax(resolution, rot_axis):
    """A unit-integral hotspot on its orbit, 2D and 3D, tilted orbit
    included: atol 1e-6 of the peak (the normalising integral is summed
    in float32 in both, in another order), integral 1 to 1e-5."""
    kw = dict(resolution=resolution, rot_axis=rot_axis, rot_angle=0.7,
              orbit_radius=4.0, std=0.9, r_isco=3.0, fov=12.0)
    ref = np.asarray(j_emission.generate_hotspot(**kw).data)
    out = emission.generate_hotspot(**kw)
    np.testing.assert_allclose(out.data.numpy() / ref.max(), ref / ref.max(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(out.integrate()), 1.0, rtol=1e-5)


def test_hotspot_within_isco_raises():
    """An orbit inside r_isco raises ValueError, as in the reference
    (test_review_regressions.py:10)."""
    with pytest.raises(ValueError, match='within r_isco'):
        emission.generate_hotspot((8, 8, 8), [0, 0, 1], 0.0,
                                  orbit_radius=2.0, std=0.5, r_isco=3.0,
                                  fov=8.0)


@pytest.mark.parametrize('where', ['inside', 'border', 'half-out', 'out'])
def test_interpolate_coords_matches_jax(setup, where):
    """Trilinear sampling against jax.scipy.ndimage.map_coordinates(order
    1, cval 0): points inside, on the border (within half a cell of it,
    where out-of-range corners blend toward 0), half outside (one
    coordinate out of range) and fully outside (all zero). atol 1e-8 of a
    field whose peak is 0.1 (float32 products in another order)."""
    rng = np.random.default_rng({'inside': 0, 'border': 1, 'half-out': 2,
                                 'out': 3}[where])
    half, cell = FOV / 2, FOV / (RES - 1)
    pts = rng.uniform(-half + cell, half - cell, (400, 3))
    if where == 'border':
        pts[:, 0] = rng.choice([-1, 1], 400) * (half + rng.uniform(
            -cell / 2, cell / 2, 400))
    elif where == 'half-out':
        pts[:, 1] = rng.choice([-1, 1], 400) * rng.uniform(
            half + 0.01, half + 4 * cell, 400)
    elif where == 'out':
        pts = rng.choice([-1, 1], (400, 3)) * rng.uniform(
            half + cell + 0.01, 3 * half, (400, 3))
    pts = pts.astype(np.float32)
    ref = np.asarray(j_emission.interpolate_coords(setup['j_hot'],
                                                   jnp.asarray(pts)))
    out = emission.interpolate_coords(setup['hot'], torch.as_tensor(pts))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-8, rtol=0)
    if where == 'out':
        assert not np.any(out.numpy())
    else:
        assert np.any(out.numpy())
    with pytest.raises(TypeError):
        emission.interpolate_coords(setup['hot'].data, torch.as_tensor(pts))


def test_image_plane_dynamics_matches_jax(setup):
    """The ground-truth movie of the hotspot against the reference's
    (assert_movie_close), with frames in one chunk and in chunks of 3:
    chunks pin t_start_obs to the first frame, so the chunked movie is
    bitwise the whole one (test_forward_model.py:169)."""
    s = setup
    whole = render(s)
    assert_movie_close(whole, s['j_movie'])
    np.testing.assert_array_equal(render(s, frame_chunk=3), whole)
    # the lightcurve modulates with the orbit
    lc = whole.sum(axis=(-1, -2))
    assert lc.max() > 1.2 * lc.min() > 0


def test_image_plane_dynamics_options_match_jax(setup):
    """slow_light=False and doppler=False against the reference
    (assert_movie_close)."""
    s = setup
    for kw in (dict(slow_light=False), dict(doppler=False)):
        assert_movie_close(render(s, **kw), j_render(s, **kw))


def test_image_plane_dynamics_movie_input(setup):
    """A movie Grid3D (a leading time axis, one field per frame) renders
    frame i from field i: a movie of scaled copies gives the scaled static
    frames, and matches the reference's movie render; a frame-count
    mismatch raises ValueError (test_review_regressions.py:177)."""
    s = setup
    gains = np.linspace(0.5, 2.0, NT).astype(np.float32)
    data = s['hot'].data[None] * torch.as_tensor(gains)[:, None, None, None]
    movie = utils.Grid3D(data, s['hot'].start, s['hot'].stop)
    j_movie = j_utils.Grid3D(jnp.asarray(data.numpy()), s['j_hot'].start,
                             s['j_hot'].stop)
    out = render(s, emission_0=movie, frame_chunk=3)
    np.testing.assert_allclose(out, render(s) * gains[:, None, None],
                               rtol=1e-6, atol=1e-12)
    assert_movie_close(out, j_render(s, emission_0=j_movie))
    short = utils.Grid3D(data[:NT - 1], s['hot'].start, s['hot'].stop)
    with pytest.raises(ValueError, match='frames'):
        render(s, emission_0=short)


def test_image_plane_dynamics_stokes_factors_match_jax(setup):
    """Per-sample Stokes factors J (3, na, nb, ngeo) give a (nt, 3, na,
    nb) movie equal to the reference's with the same J
    (assert_movie_close on each Stokes plane)."""
    s = setup
    J = np.random.default_rng(5).uniform(-1, 1, (3, 8, 8, 32)) \
        .astype(np.float32)
    out = render(s, J=J)
    ref = j_render(s, J=jnp.asarray(J))
    assert out.shape == (NT, 3, 8, 8)
    for k in range(3):
        assert_movie_close(out[:, k], ref[:, k])


# ---------------------------------------------------------------------------
# the predictor's entry points
# ---------------------------------------------------------------------------
def jax_params(learn_injection=False):
    jpred = JPredictor(**PRED_KW, learn_injection=learn_injection)
    jparams = jpred.init_params(seed=0)
    # lift the head so the emission is macroscopic
    jparams['dense_4']['bias'] = jparams['dense_4']['bias'] + 8.0
    return jpred, jax.tree_util.tree_map(np.asarray, jparams)


def test_params_to_numpy_inverts_params_from_jax():
    """params_to_numpy(params_from_jax(p)) is p exactly, with and without
    the learned injection offset."""
    for learn in (False, True):
        _, jparams = jax_params(learn)
        if learn:
            jparams['t_injection'] = np.asarray(2.5, np.float32)
        pred = NeRFPredictor(**PRED_KW, learn_injection=learn)
        back = params_to_numpy(pred.params_from_jax(jparams, device='cpu'))
        assert set(back) == set(jparams)
        for key, ref in jparams.items():
            if key == 't_injection':
                np.testing.assert_array_equal(back[key], ref)
                continue
            for leaf in ('kernel', 'bias'):
                assert back[key][leaf].dtype == np.float32
                np.testing.assert_array_equal(back[key][leaf], ref[leaf])


def test_predictor_call_matches_jax(setup):
    """NeRFPredictor.__call__ (and apply) on the setup's ray samples at
    three frame times against the reference's: rtol 1e-5, atol 1e-7
    (float32 MLP)."""
    s = setup
    jpred, jparams = jax_params()
    pred = NeRFPredictor(**PRED_KW)
    params = pred.params_from_jax(jparams, device='cpu')
    geos = s['tgeos']
    coords = np.stack([geos.x, geos.y, geos.z]).astype(np.float32)
    omega = np.asarray(geos.keplerian_omega(), np.float32)
    t = j_units.Quantity(np.asarray([0.0, 0.3, 0.9]), 'hr')
    ref = np.asarray(jpred(jparams, t, j_units.hr, jnp.asarray(coords),
                           jnp.asarray(omega), 0.0, jnp.asarray(geos.t),
                           s['t_inj']))
    with torch.no_grad():
        out = pred.apply(params, units.Quantity(t.value, 'hr'), units.hr,
                         torch.as_tensor(coords), torch.as_tensor(omega),
                         0.0, torch.as_tensor(geos.t, dtype=torch.float32),
                         s['t_inj']).numpy()
    assert out.shape == ref.shape == (3, 8, 8, 32)
    assert ref.max() > 1e-3
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)


def test_sample_3d_grid_matches_jax():
    """sample_3d_grid on a 12^3 grid, chunked over the first axis, against
    the reference's: rtol 1e-5, atol 1e-7. A learned injection offset is
    dropped, so an offset of +50 M (which would mask every sample) gives
    the same volume (test_review_regressions.py:189)."""
    jpred, jparams = jax_params()
    ref = j_sample_3d_grid(jpred, jparams, fov=FOV, resolution=12)
    pred = NeRFPredictor(**PRED_KW)
    out = sample_3d_grid(pred, pred.params_from_jax(jparams, device='cpu'),
                         fov=FOV, resolution=12, chunk=5)
    assert out.shape == ref.shape == (12, 12, 12)
    assert ref.max() > 1e-3
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)
    pred_inj = NeRFPredictor(**PRED_KW, learn_injection=True)
    params_inj = pred_inj.params_from_jax(
        dict(jparams, t_injection=np.asarray(50.0, np.float32)),
        device='cpu')
    np.testing.assert_array_equal(
        sample_3d_grid(pred_inj, params_inj, fov=FOV, resolution=12), out)


def test_mse_and_psnr_match_jax():
    """mse and psnr on float32 arrays and tensors equal the reference's
    numpy (rtol 1e-12)."""
    rng = np.random.default_rng(6)
    true = rng.random((6, 7, 8)).astype(np.float32)
    est = (true + 0.01 * rng.standard_normal(true.shape)).astype(np.float32)
    for a, b in ((true, est), (torch.as_tensor(true), torch.as_tensor(est))):
        np.testing.assert_allclose(utils.mse(a, b), j_utils.mse(true, est),
                                   rtol=1e-12)
        np.testing.assert_allclose(utils.psnr(a, b), j_utils.psnr(true, est),
                                   rtol=1e-12)


def test_grid_helpers_match_jax():
    """normalize, linspace_grid and world_to_image_coords against the
    reference: float64 helpers exactly, grid indices in float32 to 1 ulp
    of the largest."""
    v = np.asarray([3.0, -4.0, 12.0])
    np.testing.assert_array_equal(utils.normalize(v), j_utils.normalize(v))
    for a, b in zip(utils.linspace_grid((3, 4, 5), -2.0, 6.0),
                    j_utils.linspace_grid((3, 4, 5), -2.0, 6.0)):
        np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(11).uniform(-9, 9, (50, 3)).astype(
        np.float32)
    ref = np.asarray(j_utils.world_to_image_coords(
        jnp.asarray(pts), (16.0, 12.0, 8.0), (64, 32, 16)))
    out = utils.world_to_image_coords(torch.as_tensor(pts),
                                      (16.0, 12.0, 8.0), (64, 32, 16))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the pipeline end to end
# ---------------------------------------------------------------------------
def test_recovery_pipeline_matches_jax(setup):
    """Ten steps of the recovery fit in both packages, each from its own
    hotspot and movie, from the same initial params and the same frame
    indices: compacted 'gather' args, the 'full' image loss (the port's
    fused path with the kernels' plain versions, the reference's XLA
    path), Adam at lr 1e-3 -> 1e-5; then the 3D volume PSNR against each
    package's hotspot and the lightcurve error of total_movie_loss. Loss
    series rtol 2e-3 (the movies differ by up to 5e-5 of their max and the
    gradients by float32 reassociation, which Adam's normalisation
    amplifies where a gradient entry is small); psnr_3d within 0.01 dB,
    lc_err_pct rtol 1e-4."""
    s = setup
    movie = render(s)
    jpred, jparams = jax_params()
    pred = NeRFPredictor(**PRED_KW)
    t_q = units.Quantity(s['t_hr'], 'hr')
    j_t_q = j_units.Quantity(s['t_hr'], 'hr')
    geos, tgeos = s['geos'], s['tgeos']

    j_rt = j_raytracing_args(geos, geos.keplerian_omega(), s['t_inj'],
                             j_t_q[0])
    j_crt = j_step.compact_raytracing_args(j_rt, jpred, tile=TILE,
                                           layout='gather')
    rt = step.raytracing_args(tgeos, tgeos.keplerian_omega(), s['t_inj'],
                              t_q[0], device='cpu')
    crt = step.compact_raytracing_args(rt, pred, layout='gather')
    j_ts = JTrainStep.image(j_t_q, s['j_movie'], jpred, dtype='full')
    ts = TrainStep.image(t_q, movie, pred, dtype='full', fused=True,
                         device='cpu')
    j_state = JTrainState.create(jparams, j_make_optimizer(10, 1e-3, 1e-5))
    state = TrainState.create(pred.params_from_jax(jparams, device='cpu'),
                              make_optimizer(10, 1e-3, 1e-5))
    rng = np.random.default_rng(7)
    j_losses, losses = [], []
    for _ in range(10):
        idx = rng.choice(NT, 3, replace=False)
        j_loss, j_state, _ = j_ts(j_state, j_crt, idx)
        loss, state, _ = ts(state, crt, idx)
        j_losses.append(float(j_loss))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, j_losses, rtol=2e-3)
    assert losses[-1] < losses[0]

    truth, j_truth = s['hot'].data.numpy(), np.asarray(s['j_hot'].data)
    vol = sample_3d_grid(pred, state.params, fov=FOV, resolution=RES)
    j_vol = j_sample_3d_grid(jpred, j_state.params, fov=FOV, resolution=RES)
    np.testing.assert_allclose(utils.psnr(truth, vol),
                               j_utils.psnr(j_truth, j_vol), atol=0.01)

    def lc_err(frames, ref):
        lc, lc_true = frames.sum(axis=(-1, -2)), ref.sum(axis=(-1, -2))
        return 100.0 * np.mean(np.abs(lc - lc_true)) / np.mean(lc_true)

    from bhnerf_tpu.train import total_movie_loss as j_total_movie_loss
    from bhnerf_tpu_torch.train.optimizer import total_movie_loss
    _, frames = total_movie_loss(3, state, ts, crt, return_frames=True)
    _, j_frames = j_total_movie_loss(3, j_state, j_ts, j_crt,
                                     return_frames=True)
    assert frames.shape == j_frames.shape == (NT, 8, 8)
    np.testing.assert_allclose(lc_err(frames, movie),
                               lc_err(j_frames, s['j_movie']), rtol=1e-4)


# ---------------------------------------------------------------------------
# repairs: scalar Stokes factor, 'auto' layout, kernel width padding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('J', [0.5, np.asarray(0.5), torch.tensor(0.5)],
                         ids=['float', 'numpy-0d', 'tensor-0d'])
def test_scalar_J_forms_match_jax(setup, J):
    """A scalar J as a float, a 0-d numpy array or a 0-d tensor gives one
    Stokes component, unpolarized compact args whose weights are the
    float's and the reference's (rtol 1e-5 and 1e-7 of the largest: the
    Doppler factor is f64 in the port, f32 there), and the reference's loss with that J (rtol
    1e-4, as the ALMA path's losses). RayTracingArgs built with a 0-d J
    directly count one Stokes component too."""
    s = setup
    tgeos, geos = s['tgeos'], s['geos']
    pred, (jpred, jparams) = NeRFPredictor(**PRED_KW), jax_params()
    rt = step.raytracing_args(tgeos, tgeos.keplerian_omega(), s['t_inj'],
                              0.0, J=J, device='cpu')
    rt_float = step.raytracing_args(tgeos, tgeos.keplerian_omega(),
                                    s['t_inj'], 0.0, J=0.5, device='cpu')
    assert rt.num_stokes == 1
    assert dataclasses.replace(rt, J=torch.tensor(0.5)).num_stokes == 1
    crt = step.compact_raytracing_args(rt, pred)
    crt_float = step.compact_raytracing_args(rt_float, pred)
    assert not crt.polarized and crt.num_stokes == 1
    np.testing.assert_array_equal(crt.weights.numpy(),
                                  crt_float.weights.numpy())
    j_J = np.asarray(J) if isinstance(J, torch.Tensor) else J
    j_rt = j_raytracing_args(geos, geos.keplerian_omega(), s['t_inj'], 0.0,
                             J=j_J)
    j_crt = j_step.compact_raytracing_args(j_rt, jpred, tile=TILE)
    assert j_rt.num_stokes == 1
    j_w = np.asarray(j_crt.weights)
    np.testing.assert_allclose(crt.weights.numpy(), j_w, rtol=1e-5,
                               atol=1e-7 * j_w.max())
    target = np.random.default_rng(8).random((3, 8, 8)).astype(np.float32)
    t_M = np.asarray([0.0, 40.0, 90.0], np.float32)
    j_loss, _ = j_step.loss_fn_image(jparams, jpred, jnp.asarray(target),
                                     1.0, 0.0, jnp.asarray(t_M), j_crt, 1.0,
                                     'full')
    with torch.no_grad():
        loss, _ = step.loss_fn_image(
            pred.params_from_jax(jparams, device='cpu'), pred,
            torch.as_tensor(target), 1.0, 0.0, torch.as_tensor(t_M), crt,
            1.0, 'full', fused=True)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)


def test_auto_layout_is_gather_for_stokes_weights(setup):
    """'auto' with 3-row Stokes weights resolves to 'gather' in the port
    (the reference's 'auto' takes 'native'), and its 'lc' and 'full'
    losses equal the reference's 'auto' losses (rtol 1e-4, as the ALMA
    path's)."""
    s = setup
    tgeos, geos = s['tgeos'], s['geos']
    pred, (jpred, jparams) = NeRFPredictor(**PRED_KW), jax_params()
    J = np.random.default_rng(9).uniform(-1, 1, (3, 8, 8, 32)) \
        .astype(np.float32)
    rt = step.raytracing_args(tgeos, tgeos.keplerian_omega(), s['t_inj'],
                              0.0, J=J, device='cpu')
    j_rt = j_raytracing_args(geos, geos.keplerian_omega(), s['t_inj'], 0.0,
                             J=J)
    crt = step.compact_raytracing_args(rt, pred)
    j_crt = j_step.compact_raytracing_args(j_rt, jpred, tile=TILE)
    assert crt.red_gather is not None and crt.polarized
    assert j_crt.red_gather is None
    rng = np.random.default_rng(10)
    t_M = np.asarray([0.0, 40.0, 90.0], np.float32)
    params = pred.params_from_jax(jparams, device='cpu')
    for dtype, shape in (('lc', (3, 3)), ('full', (3, 3, 8, 8))):
        target = rng.random(shape).astype(np.float32)
        j_loss, _ = j_step.loss_fn_image(
            jparams, jpred, jnp.asarray(target), 1.0, 0.0, jnp.asarray(t_M),
            j_crt, 1.0, dtype)
        with torch.no_grad():
            loss, _ = step.loss_fn_image(
                params, pred, torch.as_tensor(target), 1.0, 0.0,
                torch.as_tensor(t_M), crt, 1.0, dtype, fused=True)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)


@pytest.mark.parametrize('width,depth', [(20, 4), (100, 4), (120, 2),
                                         (48, 4)])
def test_width_padding_is_exact(width, depth):
    """What the wrappers hand the kernels for a width that is no multiple
    of 16: the MLP zero-padded to the next multiple, whose emission and
    features equal the unpadded MLP's (rtol 1e-6: products over longer
    rows of zeros), and whose gradients, with the padded entries dropped,
    equal the unpadded ones (rtol 1e-5, atol 1e-7 of the largest) -
    including the skip layer, whose padded h sits in front of F (after
    layer 2 of 4, and before the head with depth 2). Width 48 needs no
    padding and passes through unchanged; over MAX_WIDTH raises."""
    rng = np.random.default_rng(width)
    pred = NeRFPredictor(scale=8.0, net_depth=depth, net_width=width)
    params = pred.init_params(generator=torch.Generator().manual_seed(0),
                              device='cpu')
    weights = [w.detach() for w in fused.pack_params(params)[0]]
    biases = [b.detach() + 0.3 for b in fused.pack_params(params)[1]]
    cfg = (depth, width, True)
    n, nt = 2 * TILE, 2
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    common = (f32(rng.uniform(0, 50, (nt, 1))), f32(rng.uniform(-8, 8, (3, n))),
              f32(rng.uniform(0.01, 0.1, (1, n))),
              f32(rng.uniform(-30, 30, (1, n))), f32(np.ones((1, n))))
    w_p, b_p, cfg_p = fused._pad_width(weights, biases, cfg)
    assert cfg_p == (depth, -(-width // 16) * 16, True)
    if width % 16 == 0:
        assert w_p is weights and b_p is biases
    em, F, H = fused.render_fwd_plain(*common, weights, biases, cfg, 8.0, 3,
                                      stash=True)
    em_p, F_p, H_p = fused.render_fwd_plain(*common, w_p, b_p, cfg_p, 8.0,
                                            3, stash=True)
    np.testing.assert_allclose(em_p.numpy(), em.numpy(), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(F_p.numpy(), F.numpy())
    # the padded units' activations are ReLU(0) = 0
    assert H_p.shape == (depth, cfg_p[1], nt * n)
    assert not H_p[:, width:].any()
    np.testing.assert_allclose(H_p[:, :width].numpy(), H.numpy(), rtol=1e-6,
                               atol=1e-9)
    g = f32(rng.standard_normal((nt, n)))
    ref = fused.render_bwd_plain(g, em, F, common[2], weights, biases, cfg,
                                 3, want_dt=True)
    gp = fused.render_bwd_plain(g, em, F, common[2], w_p, b_p, cfg_p, 3,
                                want_dt=True)
    gw, gb = fused._unpad_grads(gp[0], gp[1], weights, biases, cfg,
                                cfg_p[1])
    for a, b in zip(ref[0] + ref[1], gw + gb):
        assert a.shape == b.shape
        scale = float(a.abs().max())
        np.testing.assert_allclose(b.numpy() / scale, a.numpy() / scale,
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gp[2].numpy(), ref[2].numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match='net_width up to 128'):
        fused._pad_width(weights, biases, (depth, 136, True))
