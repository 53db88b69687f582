"""Port parity: the ALMA polarized-lightcurve training path of
bhnerf_tpu_torch against bhnerf_tpu.

Sub-pixel jitter, the polarized transport physics, the ALMA image-plane
model, both compact layouts with 3-Stokes weights, the ensemble padding,
the 'native' reduce, the compact lightcurve, the 'lc' loss with its
gradients, tv_loss, Adam with a separate injection-offset rate, and
TrainStep / Optimizer.run over a sub-pixel ensemble.

Small sizes (8x8 rays, ngeo 32, n_fine 1024, width 32, 3 variants);
inputs from numpy seeds, JAX parameters copied in with params_from_jax,
variant and frame indices passed explicitly. On the CPU the fused path
runs the kernels' plain versions; the JAX side runs Pallas in interpret
mode.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bhnerf_tpu import alma as j_alma
from bhnerf_tpu import emission as j_emission
from bhnerf_tpu import units as j_units
from bhnerf_tpu.geodesics import dataset as j_dataset
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.ops import gr as j_gr
from bhnerf_tpu.train import TrainState as JTrainState
from bhnerf_tpu.train import TrainStep as JTrainStep
from bhnerf_tpu.train import make_optimizer as j_make_optimizer
from bhnerf_tpu.train import raytracing_args as j_raytracing_args
from bhnerf_tpu.train import step as j_step

from bhnerf_tpu_torch import alma, emission, units
from bhnerf_tpu_torch.geodesics import dataset
from bhnerf_tpu_torch.geodesics.dataset import Geodesics
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.ops import fused, gr
from bhnerf_tpu_torch.train import step
from bhnerf_tpu_torch.train.optimizer import (LogFn, Optimizer, TrainStep,
                                              total_movie_loss)
from bhnerf_tpu_torch.train.state import TrainState, make_optimizer

FOV = 20.0
TRACE = dict(ngeo=32, n_fine=1024)
MODEL = {'spin': 0.0, 'fov_M': FOV, 'z_width': 4.0, 'rmin': 'ISCO',
         'Q_frac': 0.85, 'b_consts': {'arad': 0, 'avert': 1, 'ator': 0},
         'Omega_dir': 'cw', 'Omega_frac': 1.0, 'num_alpha': 8,
         'num_beta': 8, 't_start_obs': 9.4, **TRACE}
INC = np.deg2rad(60.0)
ROT = 0.3
SEED = 5
NUM_VARIANTS = 3
PRED_KW = dict(scale=FOV / 2, rmin=6.0, rmax=FOV / 2, z_width=4.0,
               net_depth=4, net_width=32, posenc_deg=3,
               learn_injection=True)
T_HR = np.linspace(9.4, 9.8, 6).astype(np.float32)
SIGMA = np.array([0.15, 1e-2, 1e-2])
TILE = fused.TILE_N
LAYOUTS = ('gather', 'native')


def to_port_geos(jg):
    return Geodesics(**{f: np.asarray(getattr(jg, f))
                        for f in Geodesics._FIELDS + Geodesics._AUX})


@pytest.fixture(scope='module')
def setup():
    """The port's 3-variant ensemble from a seed, and the reference's from
    the same seed: the same jittered grids traced by the JAX package, its
    _model_physics under x64 (the port computes the transport physics in
    float64) and its raytracing_args, which is what the reference's
    get_raytracing_args does at its fixed trace size."""
    rts = alma.get_raytracing_args(
        INC, 0.0, MODEL, rot_angle=ROT, num_subpixel_rays=NUM_VARIANTS,
        rng=np.random.default_rng(SEED), device='cpu')
    rng = np.random.default_rng(SEED)
    j_geos, j_rts, J32 = [], [], []
    for _ in range(NUM_VARIANTS):
        jg = j_dataset.image_plane_geos(
            0.0, INC, num_alpha=8, num_beta=8,
            alpha_range=[-FOV / 2, FOV / 2], beta_range=[-FOV / 2, FOV / 2],
            randomize_subpixel_rays=True, rng=rng, **TRACE)
        with jax.enable_x64(True):
            _, Omega, J = j_alma._model_physics(jg, MODEL, ROT)
            j_rts.append(j_raytracing_args(
                jg, Omega, -float(jg.r_o + FOV / 4),
                j_units.Quantity(MODEL['t_start_obs'], 'hr'), J))
        J32.append(np.asarray(j_alma._model_physics(jg, MODEL, ROT)[2]))
        j_geos.append(jg)
    jpred, pred = JPredictor(**PRED_KW), NeRFPredictor(**PRED_KW)
    jparams = jpred.init_params(seed=0)
    # lift the head so the emission (and its gradients) is macroscopic
    jparams['dense_4']['bias'] = jparams['dense_4']['bias'] + 8.0
    jparams['t_injection'] = jnp.asarray(0.5, jnp.float32)
    crts = {lay: step.compact_ensemble_args(rts, pred, layout=lay)
            for lay in LAYOUTS}
    j_crts = {lay: j_step.compact_ensemble_args(j_rts, jpred, tile=TILE,
                                                layout=lay)
              for lay in LAYOUTS}
    return dict(rts=rts, j_rts=j_rts, j_geos=j_geos, J32=J32, jpred=jpred,
                pred=pred, jparams=jparams, crts=crts, j_crts=j_crts)


def torch_params(s):
    return s['pred'].params_from_jax(
        jax.tree_util.tree_map(np.asarray, s['jparams']), device='cpu')


def same_inputs(j_args, args):
    """The reference's ray constants with the port's f32 weights, so that
    both packages start from bitwise the same inputs (the port's float64
    Doppler factor differs from the reference's float32 one in the last
    digits)."""
    jn = lambda x: None if x is None else jnp.asarray(x.numpy())
    if isinstance(args, step.CompactRayArgs):
        return dataclasses.replace(j_args, weights=jn(args.weights),
                                   red_weights=jn(args.red_weights))
    return dataclasses.replace(j_args, g=jn(args.g), J=jn(args.J))


def assert_close_normalised(b, a, atol, err_msg=''):
    scale = np.abs(a).max() + 1e-12
    np.testing.assert_allclose(np.asarray(b) / scale, np.asarray(a) / scale,
                               atol=atol, rtol=0, err_msg=err_msg)


# ---------------------------------------------------------------------------
# geodesics, Stokes helpers
# ---------------------------------------------------------------------------
def test_subpixel_jittered_axes_match_jax():
    """A seeded generator gives exactly the reference's jittered axes (the
    alpha draw, then the beta draw), also through image_plane_geos'
    screen grid, and leaves the generator in the same state."""
    ranges = ((-10.0, 10.0), (-8.0, 8.0))
    r_j, r_t = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(2):
        a_j, b_j = j_dataset.subpixel_jittered_axes(*ranges, 8, 6, r_j)
        a_t, b_t = dataset.subpixel_jittered_axes(*ranges, 8, 6, r_t)
        np.testing.assert_array_equal(a_t, a_j)
        np.testing.assert_array_equal(b_t, b_j)
    assert r_j.random() == r_t.random()


@pytest.mark.parametrize('field', ['alpha', 'beta'])
def test_randomized_screen_grid_matches_jax(setup, field):
    """image_plane_geos with randomize_subpixel_rays traces the screen
    grid that the reference draws from the same seed, exactly (the traced
    tables are held to the reference in
    test_get_raytracing_args_matches_jax)."""
    tg = dataset.image_plane_geos(
        0.0, INC, num_alpha=8, num_beta=8, alpha_range=[-FOV / 2, FOV / 2],
        beta_range=[-FOV / 2, FOV / 2], randomize_subpixel_rays=True,
        rng=np.random.default_rng(SEED), ngeo=4, n_fine=64)
    np.testing.assert_array_equal(
        getattr(tg, field), np.asarray(getattr(setup['j_geos'][0], field)))


@pytest.mark.parametrize('prop', ['Xi', 'omega', 'affine', 'coords',
                                  'num_alpha', 'num_beta', 'ngeo', 'npix'])
def test_geodesics_properties_match_jax(kerr_geos, prop):
    """Derived metric quantities and shapes of the container: the same
    float64 numpy expressions, rtol 1e-13."""
    jg, tg = kerr_geos
    np.testing.assert_allclose(getattr(tg, prop),
                               np.asarray(getattr(jg, prop)), rtol=1e-13)


def test_stokes_helpers_match_jax():
    """rotate_evpa (2, 3 and 4 components, either axis), normalize_stokes
    and apply_stokes_factors against the reference's f32 versions:
    rtol 1e-5."""
    rng = np.random.default_rng(0)
    for n, axis in ((2, 1), (3, 0), (4, 0)):
        x = rng.standard_normal((5, n) if axis else (n, 5))
        np.testing.assert_allclose(
            emission.rotate_evpa(x, 0.7, axis=axis),
            np.asarray(j_emission.rotate_evpa(x, 0.7, axis=axis)),
            rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        emission.rotate_evpa(np.zeros((5, 3)), 0.1)
    movie = rng.random((4, 4, 6, 6)) + 0.1
    for v_flux in (None, 0.05):
        np.testing.assert_allclose(
            emission.normalize_stokes(movie, 2.0, 0.3, v_flux),
            np.asarray(j_emission.normalize_stokes(movie, 2.0, 0.3, v_flux)),
            rtol=1e-5)
    em = rng.random((2, 3, 4, 5)).astype(np.float32)
    J = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    out = emission.apply_stokes_factors(torch.as_tensor(em),
                                        torch.as_tensor(J))
    assert tuple(out.shape) == (2, 3, 3, 4, 5)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(j_emission.apply_stokes_factors(em, J)),
        rtol=1e-6)
    same = torch.as_tensor(em)
    assert emission.apply_stokes_factors(same, 1.0) is same
    np.testing.assert_allclose(
        emission.apply_stokes_factors(same, 2.5).numpy(), 2.5 * em)


# ---------------------------------------------------------------------------
# transport physics
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def kerr_geos():
    """One spinning-hole table from the JAX tracer, in both containers."""
    jg = j_dataset.image_plane_geos(
        0.6, INC, num_alpha=8, num_beta=8, alpha_range=[-10, 10],
        beta_range=[-10, 10], **TRACE)
    return jg, to_port_geos(jg)


def _physics(lib, geos, name):
    """One transport operator of either package on a Keplerian flow with a
    tilted field."""
    Omega = geos.keplerian_omega(direction=-1.0)
    umu = lib.azimuthal_velocity_vector(geos, Omega)
    if name == 'inv_metric_components':
        g = lib.inv_metric_components(geos.r, geos.theta, geos.spin)
        return lib.raise_or_lower_indices(g, lib.wave_vector(geos))
    if name == 'zamo_frame_velocity':
        return lib.zamo_frame_velocity(geos, 0.4, 0.3)
    if name == 'zamo_frame_tetrad':
        return lib.zamo_frame_tetrad(geos, 0.4, 0.3)
    if name == 'fluid_frame_tetrad':
        return lib.fluid_frame_tetrad(geos, umu)
    b = lib.magnetic_field_fluid_frame(geos, umu, arad=0.3, avert=1.0,
                                       ator=0.2)
    if name == 'magnetic_field_fluid_frame':
        return b
    g = lib.doppler_factor(geos, umu)
    if name == 'parallel_transport':
        return lib.parallel_transport(geos, umu, g, b, Q_frac=0.85,
                                      V_frac=0.01)
    if name == 'parallel_transport_zamo':
        return lib.parallel_transport_zamo(geos, 0.4, 0.3, g, b, Q_frac=0.5)
    raise ValueError(name)


PHYSICS = ['inv_metric_components', 'zamo_frame_velocity',
           'zamo_frame_tetrad', 'fluid_frame_tetrad',
           'magnetic_field_fluid_frame', 'parallel_transport',
           'parallel_transport_zamo']


@pytest.mark.parametrize('name', PHYSICS)
def test_transport_physics_matches_jax(kerr_geos, name):
    """The port's float64 numpy operators against the reference's under
    jax.enable_x64: rtol 1e-9 on finite entries, the same NaN/inf pattern.
    Against the reference's default float32 (the port's deliberate
    difference) the drift inside an emission shell (6 < r < 10, |z| < 4),
    relative to the largest entry there, stays below 1e-5: measured
    2e-7 for the metric and the tetrads, 7e-7 for the fluid-frame field
    and 2e-6 for the transport factors. Outside the shell the factors
    reach 1e20 where the photon's frame momentum vanishes, and NaNs where
    no circular orbit exists."""
    jg, tg = kerr_geos
    out = np.asarray(_physics(gr, tg, name))
    with jax.enable_x64(True):
        ref = np.asarray(_physics(j_gr, jg, name))
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.float64
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), finite)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    assert finite.mean() > 0.5
    np.testing.assert_allclose(out[finite], ref[finite], rtol=1e-9,
                               atol=1e-9 * np.abs(ref[finite]).max())
    ref32 = np.asarray(_physics(j_gr, jg, name))
    assert ref32.dtype == np.float32
    shell = (tg.r > 6) & (tg.r < 10) & (np.abs(tg.z) < 4)
    if name.startswith('parallel_transport'):      # Stokes axis first
        out, ref32 = np.moveaxis(out, 0, -1), np.moveaxis(ref32, 0, -1)
    out, ref32 = out[shell], ref32[shell]
    assert np.isfinite(out).all() and np.isfinite(ref32).all()
    drift = np.abs(out - ref32).max() / np.abs(out).max()
    assert drift < 1e-5, drift


def test_transform_coordinates_and_validation():
    """'upper' and 'lower' contractions against the reference (rtol
    1e-12); a bad contraction or Q_frac raises as there."""
    rng = np.random.default_rng(1)
    tetrad, v = rng.standard_normal((5, 4, 4)), rng.standard_normal((5, 4))
    with jax.enable_x64(True):
        for c in ('upper', 'lower'):
            np.testing.assert_allclose(
                gr.transform_coordinates(v, tetrad, c),
                np.asarray(j_gr.transform_coordinates(
                    jnp.asarray(v), jnp.asarray(tetrad), c)), rtol=1e-12)
    with pytest.raises(ValueError):
        gr.transform_coordinates(v, tetrad, 'sideways')
    with pytest.raises(ValueError):
        gr.parallel_transport(None, None, None, None, Q_frac=1.5)
    with pytest.raises(ValueError):
        gr.parallel_transport_zamo(None, 0.1, 0.1, None, None, Q_frac=-0.1)


@pytest.mark.parametrize('field', ['coords', 'Omega', 'J', 'g', 'dtau',
                                   'Sigma', 't_geos_rel', 'aux'])
def test_get_raytracing_args_matches_jax(setup, field):
    """alma.get_raytracing_args (image_plane_model, _model_physics,
    raytracing_args with J[(I, Q, U)]) for every variant of a seeded
    ensemble against the reference's under x64: f32 leaves to rtol 2e-6
    (one rounding of nearly equal float64 values), J also against the
    reference's default float32 physics to 2e-4 of the largest in-domain
    factor."""
    for k, (rt, j_rt) in enumerate(zip(setup['rts'], setup['j_rts'])):
        if field == 'aux':
            assert rt.num_stokes == j_rt.num_stokes == 3
            assert rt.t_start_obs == j_rt.t_start_obs
            assert rt.t_to_M == j_rt.t_to_M
            assert rt.t_units == units.hr
            assert float(rt.t_injection) == 0.0
            continue
        a = np.asarray(getattr(j_rt, field))
        b = getattr(rt, field).numpy()
        assert a.shape == b.shape and b.dtype == np.float32
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=2e-6,
                                   atol=2e-6 * np.abs(a).max())
        if field == 'J':
            c = rt.coords.numpy()
            r = np.sqrt((c ** 2).sum(0))
            dom = (r > 6.0) & (r < FOV / 2) & (np.abs(c[2]) < 4.0)
            scale = np.abs(b[:, dom]).max()
            drift = np.abs(b - setup['J32'][k])[:, dom].max() / scale
            assert drift < 2e-4, drift
    assert not np.allclose(setup['rts'][0].coords.numpy(),
                           setup['rts'][1].coords.numpy())


def test_single_variant_is_the_regular_grid():
    """num_subpixel_rays=1 traces the regular grid and takes the chosen
    Stokes components in order."""
    small = dict(MODEL, ngeo=8, n_fine=128)
    rt, = alma.get_raytracing_args(INC, 0.0, small, stokes=('Q', 'U'),
                                   device='cpu')
    assert rt.num_stokes == 2 and tuple(rt.J.shape) == (2, 8, 8, 8)
    geos, _, J = alma.image_plane_model(INC, 0.0, small)
    np.testing.assert_array_equal(geos.alpha[:, 0], np.linspace(-10, 10, 8))
    np.testing.assert_array_equal(rt.J.numpy(), J[1:].astype(np.float32))


# ---------------------------------------------------------------------------
# compact layouts
# ---------------------------------------------------------------------------
FIELDS = ['coords', 'Omega', 'weights', 't_geos_rel', 'pixel_ids',
          'red_gather', 'red_weights', 'red_group_ids']


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('field', FIELDS)
def test_compact_layouts_match_jax(setup, layout, field):
    """compact_ensemble_args -> compact_raytracing_args with 3-Stokes
    weights in both layouts, every variant padded to the ensemble's
    maxima, field by field against the reference built with the port's
    tile: integers and the layout exactly, floats to rtol 1e-5 (the
    weights carry the f64-vs-f32 Doppler factor)."""
    for crt, j_crt in zip(setup['crts'][layout], setup['j_crts'][layout]):
        a, b = getattr(j_crt, field), getattr(crt, field)
        if layout == 'native' and field in ('red_gather', 'red_weights'):
            assert a is None and b is None
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        if b.dtype == np.int64:
            np.testing.assert_array_equal(b, a.astype(np.int64))
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=0)
        assert crt.polarized and crt.num_stokes == 3
        assert crt.image_shape == (8, 8)


@pytest.mark.parametrize('layout', LAYOUTS)
def test_ensemble_shapes_uniform(setup, layout):
    """Variants with different in-domain counts come out identically
    shaped, at the reference's shapes; alone they would not."""
    crts, j_crts = setup['crts'][layout], setup['j_crts'][layout]
    shape = lambda c: (tuple(c.coords.shape), tuple(c.weights.shape),
                       tuple(c.red_group_ids.shape))
    assert len({shape(c) for c in crts}) == 1
    assert shape(crts[0]) == shape(j_crts[0])
    alone = {shape(step.compact_raytracing_args(rt, setup['pred'],
                                                layout=layout))
             for rt in setup['rts']}
    assert len(alone) > 1
    n = crts[0].coords.shape[-1]
    assert n % TILE == 0
    if layout == 'native':
        assert n == 8 * crts[0].red_group_ids.shape[0]
        filler = crts[0].t_geos_rel < -1e29
        assert 0.1 < float(filler.float().mean()) < 0.6
        assert bool((crts[0].coords[:, filler] == 0).all())
        assert bool((crts[0].weights[:, filler] == 0).all())


def test_auto_layout_chooses_as_jax(setup):
    """'auto' is 'gather' in the port for multi-Stokes weights, where the
    reference takes 'native' (a TPU workaround left behind), and 'gather'
    for a scalar J in both; an unknown layout raises."""
    s = setup
    rt, j_rt = s['rts'][0], s['j_rts'][0]
    crt = step.compact_raytracing_args(rt, s['pred'])
    j_crt = j_step.compact_raytracing_args(j_rt, s['jpred'], tile=TILE)
    assert crt.red_gather is not None and j_crt.red_gather is None
    assert crt.polarized and crt.num_stokes == 3
    rt1 = dataclasses.replace(rt, J=1.0)
    j_rt1 = dataclasses.replace(j_rt, J=1.0)
    crt1 = step.compact_raytracing_args(rt1, s['pred'])
    j_crt1 = j_step.compact_raytracing_args(j_rt1, s['jpred'], tile=TILE)
    assert crt1.red_gather is not None and j_crt1.red_gather is not None
    assert not crt1.polarized and crt1.num_stokes == 1
    assert crt1.coords.shape == j_crt1.coords.shape
    with pytest.raises(ValueError):
        step.compact_raytracing_args(rt, s['pred'], layout='dense')


def test_native_reduce_matches_jax_and_segment_sum(setup):
    """_NativeReduce forward and backward against the reference's
    _native_reduce (value and vjp) and against the plain segment sum over
    the same slots: rtol 1e-5 (f32 reassociation); filler slots get a
    zero gradient."""
    crt = setup['crts']['native'][0]
    n = crt.coords.shape[-1]
    rng = np.random.default_rng(1)
    em0 = rng.random((4, n)).astype(np.float32)
    w_img = rng.standard_normal((4, 3, 64)).astype(np.float32)
    outs = []
    for reduce in (lambda em: step._reduce_to_images(em, crt),
                   lambda em: step._segment_reduce(crt.npix, em,
                                                   crt.pixel_ids,
                                                   crt.weights)):
        em = torch.as_tensor(em0).requires_grad_(True)
        img = reduce(em)
        (img * torch.as_tensor(w_img)).sum().backward()
        outs.append((img.detach().numpy(), em.grad.numpy()))
    j_img, vjp = jax.vjp(
        lambda em: j_step._native_reduce(
            crt.npix, em, jnp.asarray(crt.weights.numpy()),
            jnp.asarray(crt.red_group_ids.numpy(), jnp.int32)),
        jnp.asarray(em0))
    outs.append((np.asarray(j_img), np.asarray(vjp(jnp.asarray(w_img))[0])))
    assert outs[0][0].shape == (4, 3, 64)
    for img, d_em in outs[1:]:
        np.testing.assert_allclose(outs[0][0], img, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(outs[0][1], d_em, rtol=1e-5, atol=1e-6)
    filler = (crt.t_geos_rel < -1e29).numpy()
    assert (outs[0][1][:, filler] == 0).all()


# ---------------------------------------------------------------------------
# images, lightcurves, losses
# ---------------------------------------------------------------------------
def frames_M(rt):
    return rt.frame_times_M(torch.as_tensor(T_HR[:3]))


@pytest.mark.parametrize('layout', LAYOUTS)
def test_polarized_compact_matches_dense(setup, layout):
    """Polarized compact fused images against the dense plain pipeline of
    the port, (nt, 3, 8, 8): atol 2e-5 after normalising by the max
    (test_compact.py:50); and against the reference's compact fused
    images (Pallas interpret mode): atol 2e-6 normalised."""
    s = setup
    rt, crt = s['rts'][0], s['crts'][layout][0]
    with torch.no_grad():
        dense = step.image_plane_prediction(torch_params(s), s['pred'],
                                            frames_M(rt), rt).numpy()
        compact = step.image_plane_prediction(
            torch_params(s), s['pred'], frames_M(crt), crt,
            fused=True).numpy()
    assert compact.shape == dense.shape == (3, 3, 8, 8)
    assert np.abs(dense[:, 1:]).max() > 1e-3 * np.abs(dense).max()
    assert_close_normalised(compact, dense, 2e-5)
    j_crt = same_inputs(s['j_crts'][layout][0], crt)
    ref = np.asarray(j_step.image_plane_prediction(
        s['jparams'], s['jpred'], jnp.asarray(frames_M(crt).numpy()), j_crt,
        fused=True))
    assert_close_normalised(compact, ref, 2e-6)


@pytest.mark.parametrize('layout', LAYOUTS)
def test_compact_lightcurve_matches_image_sum_and_jax(setup, layout):
    """lc = em @ W^T against the pixel sum of the compact images and
    against the reference's compact_lightcurve: atol 2e-5 after
    normalising (test_compact.py:261: the sums run over ~10^2..10^5 f32
    terms in different orders); the unpolarized lightcurve drops the
    Stokes axis; compact_image_and_lightcurve returns the same pair from
    one emission pass."""
    s = setup
    crt = s['crts'][layout][0]
    params = torch_params(s)
    t_M = frames_M(crt)
    with torch.no_grad():
        lc = step.compact_lightcurve(params, s['pred'], t_M, crt,
                                     fused=True)
        img = step.image_plane_prediction(params, s['pred'], t_M, crt,
                                          fused=True)
        img2, lc2 = step.compact_image_and_lightcurve(params, s['pred'], t_M,
                                                      crt, fused=True)
    assert tuple(lc.shape) == (3, 3)
    assert_close_normalised(lc.numpy(), img.sum(dim=(-1, -2)).numpy(), 2e-5)
    assert torch.equal(lc2, lc) and torch.equal(img2, img)
    ref = np.asarray(j_step.compact_lightcurve(
        s['jparams'], s['jpred'], jnp.asarray(t_M.numpy()),
        same_inputs(s['j_crts'][layout][0], crt), fused=True))
    assert_close_normalised(lc.numpy(), ref, 2e-5)
    crt1 = dataclasses.replace(crt, weights=crt.weights[:1].contiguous(),
                               polarized=False)
    with torch.no_grad():
        lc1 = step.compact_lightcurve(params, s['pred'], t_M, crt1)
    assert tuple(lc1.shape) == (3,)
    assert_close_normalised(lc1.numpy(), lc[:, 0].numpy(), 2e-5)


def lc_target(seed=2, nt=3):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.random((nt, 3))).astype(np.float32)


@pytest.mark.parametrize('kind', ['dense', 'gather', 'native'])
def test_lc_loss_and_gradients_match_jax(setup, kind):
    """The 'lc' chi-square with sigma (3,) against an (nt, 3) target, its
    aux images, its parameter gradients and d loss / d t_injection (the
    learnable offset) against the reference's on the same inputs, for
    dense ray constants (plain path) and both compact layouts (fused:
    plain kernels here, Pallas interpret mode there). Loss rtol 1e-4,
    images atol 2e-5 normalised, gradients atol 1e-4 normalised per leaf
    (test_compact.py:79-84), d t_injection rtol 2e-3."""
    s = setup
    rt = s['rts'][1] if kind == 'dense' else s['crts'][kind][1]
    j_rt = same_inputs(s['j_rts'][1] if kind == 'dense'
                       else s['j_crts'][kind][1], rt)
    use_fused = kind != 'dense'
    target = lc_target()
    sigma = np.broadcast_to(SIGMA, target.shape).astype(np.float32)
    offset = np.zeros_like(target)
    t_M = frames_M(rt)

    params = torch_params(s)
    tt = torch.as_tensor
    loss, [images] = step.loss_fn_image(
        params, s['pred'], tt(target), tt(sigma), tt(offset), t_M, rt, 1.0,
        'lc', fused=use_fused)
    loss.backward()

    def j_loss(p):
        return j_step.loss_fn_image(
            p, s['jpred'], jnp.asarray(target), jnp.asarray(sigma),
            jnp.asarray(offset), jnp.asarray(t_M.numpy()), j_rt, 1.0, 'lc',
            fused=use_fused)

    (ref_loss, [ref_images]), ref_grads = jax.value_and_grad(
        j_loss, has_aux=True)(s['jparams'])
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-4)
    assert tuple(images.shape) == (3, 3, 8, 8)
    assert_close_normalised(images.detach().numpy(), ref_images, 2e-5)
    for i, layer in enumerate(params.mlp.layers):
        g = ref_grads[f'dense_{i}']
        assert_close_normalised(layer.weight.grad.numpy(),
                                np.asarray(g['kernel']).T, 1e-4, f'W{i}')
        assert_close_normalised(layer.bias.grad.numpy(),
                                np.asarray(g['bias']), 1e-4, f'b{i}')
    d_t = float(params.t_injection.grad)
    assert abs(d_t) > 0
    np.testing.assert_allclose(d_t, float(ref_grads['t_injection']),
                               rtol=2e-3)


def test_unpolarized_lc_and_unknown_dtype(setup):
    """A scalar-J lightcurve loss takes an (nt,) target; dense and
    compact agree to rtol 1e-4; an unknown dtype raises ValueError as in
    the reference."""
    s = setup
    rt1 = dataclasses.replace(s['rts'][0], J=2.0)
    crt1 = step.compact_raytracing_args(rt1, s['pred'])
    params = torch_params(s)
    target = torch.as_tensor(lc_target()[:, 0])
    one = torch.ones_like(target)
    losses = []
    with torch.no_grad():
        for rt in (rt1, crt1):
            loss, [img] = step.loss_fn_image(
                params, s['pred'], target, one, 0 * one, frames_M(rt), rt,
                0.5, 'lc', fused=True)
            assert tuple(img.shape) == (3, 8, 8)
            losses.append(float(loss))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    with pytest.raises(ValueError):
        step.loss_fn_image(params, s['pred'], target, one, one,
                           frames_M(rt1), rt1, 1.0, 'visibility')


def test_tv_loss_matches_jax(setup):
    """tv_loss and its parameter gradients on a 12^3 grid against the
    reference: value rtol 1e-4, gradients atol 1e-4 normalised; and
    tv_scale adds it to the step's loss."""
    s = setup
    params = torch_params(s)
    tv = step.tv_loss(params, s['pred'], FOV, 12)
    tv.backward()
    ref, ref_grads = jax.value_and_grad(
        lambda p: j_step.tv_loss(p, s['jpred'], FOV, 12))(s['jparams'])
    assert float(tv) > 0
    np.testing.assert_allclose(float(tv), float(ref), rtol=1e-4)
    for i, layer in enumerate(params.mlp.layers):
        assert_close_normalised(
            layer.weight.grad.numpy(),
            np.asarray(ref_grads[f'dense_{i}']['kernel']).T, 1e-4)

    crt = s['crts']['gather'][0]
    target = lc_target(nt=len(T_HR))
    args = [torch.as_tensor(np.asarray(a, np.float32)) for a in
            (target, np.broadcast_to(SIGMA, target.shape), 0 * target, T_HR)]
    state = TrainState.create(torch_params(s), make_optimizer(10))
    idx = torch.arange(3)
    plain = step.make_step_fns(s['pred'], dtype='lc', fused=True)[1]
    with_tv = step.make_step_fns(s['pred'], dtype='lc', fused=True,
                                 tv_scale=3.0, tv_fov=FOV,
                                 tv_resolution=12)[1]
    # a small loss scale, so that f32 resolves the penalty beside the
    # chi-square
    l0 = float(plain(state, *args, idx, crt, 1e-6)[0])
    l1 = float(with_tv(state, *args, idx, crt, 1e-6)[0])
    np.testing.assert_allclose(l1 - l0, 3.0 * float(tv), rtol=1e-3)


# ---------------------------------------------------------------------------
# Adam with the injection offset's own rate; TrainStep over an ensemble
# ---------------------------------------------------------------------------
def test_adam_with_lr_inject_matches_optax(setup):
    """Four 'lc' grad steps with lr_inject: the port's two parameter
    groups against optax's chain of masked Adams in the reference's
    gather-in-jit step, same frame indices, same initial params. MLP
    parameters atol 2e-5 (as the Adam test of test_torch_train.py);
    t_injection, which moves lr_inject = 1e-2 a step, atol 2e-4; the
    scheduled group's rate follows the schedule, the offset's stays."""
    s = setup
    crt = s['crts']['gather'][0]
    j_crt = same_inputs(s['j_crts']['gather'][0], crt)
    target = lc_target(3, nt=len(T_HR))
    sigma = np.broadcast_to(SIGMA, target.shape).astype(np.float32)
    offset = np.zeros_like(target)
    rng = np.random.default_rng(3)
    indices = [rng.choice(len(T_HR), 3, replace=False) for _ in range(4)]
    kw = dict(num_iters=10, lr_init=1e-4, lr_final=1e-5, lr_inject=1e-2)

    j_state = JTrainState.create(s['jparams'], j_make_optimizer(**kw))
    j_grad, _ = j_step.make_step_fns(s['jpred'], kind='image', dtype='lc',
                                     fused=False, gather=True)
    for idx in indices:
        j_loss, j_state, _ = j_grad(
            j_state, jnp.asarray(target), jnp.asarray(sigma),
            jnp.asarray(offset), jnp.asarray(T_HR),
            jnp.asarray(idx, jnp.int32), j_crt, 1.0)

    state = TrainState.create(torch_params(s), make_optimizer(**kw))
    grad, _ = step.make_step_fns(s['pred'], dtype='lc', fused=True)
    tt = torch.as_tensor
    for idx in indices:
        loss, state, _ = grad(state, tt(target), tt(sigma), tt(offset),
                              tt(T_HR), tt(idx), crt, 1.0)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-3)
    for i, layer in enumerate(state.params.mlp.layers):
        jp = j_state.params[f'dense_{i}']
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   np.asarray(jp['kernel']).T, atol=2e-5)
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   np.asarray(jp['bias']), atol=2e-5)
    t_inj = float(state.params.t_injection.detach())
    assert abs(t_inj - 0.5) > 1e-2, 'the offset did not move'
    np.testing.assert_allclose(t_inj, float(j_state.params['t_injection']),
                               atol=2e-4)
    scheduled, inject = state.opt.param_groups
    assert inject['lr'] == 1e-2 and len(inject['params']) == 1
    np.testing.assert_allclose(scheduled['lr'], state.tx.lr(3))
    # without lr_inject the offset follows the schedule with the rest
    plain = TrainState.create(torch_params(s), make_optimizer(10))
    assert len(plain.opt.param_groups) == 1
    assert len(plain.opt.param_groups[0]['params']) == 11


def ensemble_step(s, layout, nt=len(T_HR), flux=1.0):
    target = flux * lc_target(4, nt=nt)
    return TrainStep.image(units.Quantity(T_HR[:nt], 'hr'), target,
                           s['pred'], sigma=SIGMA, dtype='lc', fused=True,
                           device='cpu'), target


@pytest.mark.parametrize('layout', LAYOUTS)
def test_train_step_over_ensemble(setup, layout):
    """TrainStep over a list of ray constants. Test mode: loss and images
    are the mean over all variants, and equal the reference's TrainStep in
    test mode on the same inputs (loss rtol 1e-4, images atol 2e-5
    normalised). Gradient mode: `variant` picks the one variant trained
    on (bitwise the single-variant step), and an ensemble without
    `variant` raises."""
    s = setup
    crts = s['crts'][layout]
    train_step, target = ensemble_step(s, layout)
    state = TrainState.create(torch_params(s), make_optimizer(10))
    idx = np.array([0, 2, 5])
    loss, _, images = train_step(state, crts, idx, update_state=False)
    singles = [train_step(state, c, idx, update_state=False) for c in crts]
    np.testing.assert_allclose(
        float(loss), np.mean([float(x[0]) for x in singles]), rtol=1e-6)
    np.testing.assert_allclose(
        images.numpy(), np.mean([x[2].numpy() for x in singles], axis=0),
        rtol=1e-5, atol=1e-9)
    assert tuple(images.shape) == (3, 3, 8, 8)
    assert not np.allclose(singles[0][2].numpy(), singles[1][2].numpy())

    j_train_step = JTrainStep.image(
        j_units.Quantity(T_HR, 'hr'), target, s['jpred'], sigma=SIGMA,
        dtype='lc', fused=True)
    j_state = JTrainState.create(s['jparams'], j_make_optimizer(10))
    j_list = [same_inputs(j, c) for j, c in zip(s['j_crts'][layout], crts)]
    j_loss, _, j_images = j_train_step(j_state, j_list, idx,
                                       update_state=False)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    assert_close_normalised(images.numpy(), j_images, 2e-5)

    with pytest.raises(ValueError):
        train_step(state, crts, idx)
    results = []
    for rt_arg, kw in ((crts, dict(variant=2)), (crts[2], {})):
        st = TrainState.create(torch_params(s), make_optimizer(10))
        l, st, _ = train_step(st, rt_arg, idx, **kw)
        results.append((float(l), st.params.mlp.layers[0].weight.detach()))
        assert st.step == 1
    assert results[0][0] == results[1][0]
    assert torch.equal(results[0][1], results[1][1])


def test_train_step_composition_and_total_movie_loss(setup):
    """`+` concatenates the per-loss lists; a step then applies every loss
    in turn (two state updates) and sums the losses; losses with different
    frame counts refuse to compose. total_movie_loss is the test loss over
    all frames per frame, the last chunk holding the frames left over."""
    s = setup
    crt = s['crts']['gather'][0]
    a, _ = ensemble_step(s, 'gather')
    b, _ = ensemble_step(s, 'gather')
    both = a + b
    assert both.num_losses == 2 and both.dtype == ['lc', 'lc']
    assert both.args[0].t_start_obs == units.Quantity(T_HR, 'hr')[0]
    state = TrainState.create(torch_params(s), make_optimizer(10))
    idx = np.array([1, 3, 4])
    l_one = float(a(state, crt, idx, update_state=False)[0])
    l_two = float(both(state, crt, idx, update_state=False)[0])
    np.testing.assert_allclose(l_two, 2 * l_one, rtol=1e-6)
    both(state, crt, idx)
    assert state.step == 2
    short, _ = ensemble_step(s, 'gather', nt=4)
    with pytest.raises(ValueError):
        a + short

    state = TrainState.create(torch_params(s), make_optimizer(10))
    total, frames = total_movie_loss(4, state, a, s['crts']['gather'],
                                     return_frames=True)
    assert frames.shape == (len(T_HR), 3, 8, 8)
    parts = [float(a(state, s['crts']['gather'], inds,
                     update_state=False)[0])
             for inds in (np.arange(4), np.arange(4, 6))]
    np.testing.assert_allclose(total, sum(parts) / len(T_HR), rtol=1e-6)
    assert total_movie_loss(4, state, a, s['crts']['gather']) == total


@pytest.mark.parametrize('layout', LAYOUTS)
def test_optimizer_run_lc_ensemble_lowers_loss(setup, layout):
    """Optimizer.run with dtype='lc', lr_inject and a 3-variant ensemble
    at the small size: every loss finite, the test loss over the ensemble
    falls, every variant is drawn, the offset moves at its own rate, and
    no kernel is launched (CPU tensors take the plain versions)."""
    s = setup
    crts = s['crts'][layout]
    # a faint target: freshly drawn weights start at an emission of e^-10
    train_step, _ = ensemble_step(s, layout, flux=0.02)
    opt = Optimizer({'num_iters': 30, 'lr_init': 1e-2, 'lr_final': 3e-3,
                     'lr_inject': 1e-3, 'seed': 0}, s['pred'], crts,
                    device='cpu')
    drawn, losses = [], []
    inner = train_step.grad_fn[0]

    def spy(state, *args):
        drawn.append(next(k for k, c in enumerate(crts) if c is args[-2]))
        return inner(state, *args)

    train_step.grad_fn[0] = spy
    before = total_movie_loss(6, opt.state, train_step, crts)
    launches = (fused.render_fwd.launches, fused.render_bwd.launches)
    opt.run(3, train_step, crts,
            log_fns=[LogFn(lambda o: losses.append(float(o.loss)))],
            verbose=False)
    after = total_movie_loss(6, opt.state, train_step, crts)
    assert len(losses) == 30 and opt.state.step == 30
    assert np.all(np.isfinite(losses))
    assert after < 0.8 * before
    assert set(drawn) == {0, 1, 2}
    assert float(opt.state.params.t_injection.detach()) != 0.0
    assert opt.state.opt.param_groups[1]['lr'] == 1e-3
    assert (fused.render_fwd.launches, fused.render_bwd.launches) == launches


# ---------------------------------------------------------------------------
# data preprocessing
# ---------------------------------------------------------------------------
def test_preprocess_data_matches_jax(tmp_path):
    """preprocess_data on a seeded synthetic CSV with a scan gap, a
    missing value and rows outside the time window, numpy alone against
    the reference's pandas: the same frames (times rtol 1e-12) and target
    (the reference de-rotates in float32: rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(0)
    n = 600
    t = 9.2 + np.arange(n) * 4.0 / 3600          # 4 s cadence
    t[300:] += 0.2                               # a scan gap
    Q = 0.1 * np.cos(2 * np.pi * t / 0.5) + 0.16 * np.cos(
        2 * np.deg2rad(-37.0)) + 0.01 * rng.standard_normal(n)
    U = 0.1 * np.sin(2 * np.pi * t / 0.5) + 0.16 * np.sin(
        2 * np.deg2rad(-37.0)) + 0.01 * rng.standard_normal(n)
    I = 2.4 + 0.01 * rng.standard_normal(n)
    path = tmp_path / 'alma.csv'
    with open(path, 'w') as f:
        f.write(',time,I,Q,U\n')
        for k in range(n):
            q = '' if k == 150 else repr(float(Q[k]))
            f.write(f'{k},{float(t[k])!r},{float(I[k])!r},{q},'
                    f'{float(U[k])!r}\n')
    kw = dict(window_size=8, I_hs_mean=0.3, P_sha=0.16, chi_sha=-37.0,
              de_rot_angle=32.2, t_start=9.3005, t_end=9.9505)
    target, t_frames = alma.preprocess_data(str(path), **kw)
    ref_target, ref_t = j_alma.preprocess_data(str(path), **kw)
    assert t_frames.unit == units.hr
    assert target.shape == np.shape(ref_target) and target.shape[1] == 3
    assert 40 < len(target) < n // 8
    np.testing.assert_allclose(np.asarray(t_frames.value),
                               np.asarray(ref_t.value), rtol=1e-12)
    np.testing.assert_allclose(target, np.asarray(ref_target), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(target[:, 0], 0.3)
    with open(path, 'w') as f:
        f.write(',time,I\n0,9.4,2.0\n')
    with pytest.raises(ValueError):
        alma.preprocess_data(str(path), **kw)
