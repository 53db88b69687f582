"""Port parity for the synthetic-truth layer: the field utilities of
bhnerf_tpu_torch.utils (spherical_coords_to_rotation_axis, expand_3d,
anti_aliasing_filter, gaussian_random_field, fft_transform) and the
emission generators generate_tube, propogate_flatspace_emission and
grf_to_image_plane, against bhnerf_tpu on the same seeded numpy inputs.

Tolerances: the geometric generators at rtol 1e-6 (both build their
rotations in float32 and their blobs in float64); the FFT helpers within
1e-5 of the largest magnitude (the JAX package computes in complex64);
the renders within 5e-5 of their largest value, the bar the recovery
movie meets (tests/test_torch_recovery.py); the random field's
noise-to-field map, fed the JAX package's own draws, within 1e-10 (both
in float64). Small sizes: one 8x8x24 table traced by the port's host
tracer (n_fine 512) and read by the JAX package from its npz.
"""
import numpy as np
import pytest

import jax
import jax.random as jr

from bhnerf_tpu import emission as j_emission
from bhnerf_tpu import utils as j_utils
from bhnerf_tpu.geodesics.dataset import Geodesics as JGeodesics

import torch

from bhnerf_tpu_torch import emission, utils
from bhnerf_tpu_torch.geodesics import image_plane_geos

FOV = 16.0


def test_generate_tube_matches_jax():
    """A quarter-orbit tube in the equatorial plane and one on a tilted
    orbit, normalised and not, at rtol 1e-6."""
    for rot_axis, normalize in (([0, 0, 1], True), ([1.0, 0.5, 1.0], False)):
        kw = dict(resolution=(16, 16, 12), rot_axis=rot_axis,
                  phi_start=0.3, phi_end=0.3 + np.pi / 2, orbit_radius=5.0,
                  std=1.2, r_isco=4.0, fov=FOV, std_clip=3.0,
                  normalize=normalize)
        port = emission.generate_tube(**kw)
        ref = j_emission.generate_tube(**kw)
        assert port.data.dtype == torch.float32
        assert (port.start, port.stop) == (ref.start, ref.stop)
        np.testing.assert_allclose(port.data.numpy(), np.asarray(ref.data),
                                   rtol=1e-6, atol=1e-6 * float(
                                       np.abs(ref.data).max()))


def test_generate_tube_refuses_empty_range_and_isco():
    kw = dict(resolution=(8, 8, 8), rot_axis=[0, 0, 1], orbit_radius=5.0,
              std=1.0, r_isco=4.0, fov=FOV)
    for module in (emission, j_emission):
        with pytest.raises(ValueError, match='empty tube range'):
            module.generate_tube(phi_start=1.0, phi_end=1.0, **kw)
        with pytest.raises(ValueError, match='r_isco'):
            module.generate_tube(phi_start=0.0, phi_end=1.0,
                                 **dict(kw, r_isco=6.0))


@pytest.mark.parametrize('theta,phi', [(0.3, 1.1), (np.pi / 2, -0.5),
                                       (2.5, 3.0), (0.0, 0.7), (np.pi, 0.2)],
                         ids=['tilted', 'equator', 'south', 'north-pole',
                              'south-pole'])
def test_spherical_coords_to_rotation_axis_matches_jax(theta, phi):
    """Both packages' axis at rtol 1e-6 (atol 1e-7 for the components
    that cancel to zero in a float32 rotation), the poles included, where
    the axis is +-z; the angle is phi."""
    axis, angle = utils.spherical_coords_to_rotation_axis(theta, phi)
    ref_axis, ref_angle = j_utils.spherical_coords_to_rotation_axis(theta,
                                                                    phi)
    assert np.isfinite(axis).all() and angle == ref_angle == phi
    np.testing.assert_allclose(axis, np.asarray(ref_axis), rtol=1e-6,
                               atol=1e-7)
    if theta in (0.0, np.pi):
        np.testing.assert_array_equal(axis, [0.0, 0.0,
                                             np.sign(np.cos(theta))])


def _close_to_max(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = np.abs(b).max()
    assert scale > 0
    np.testing.assert_array_less(np.abs(a - b), tol * scale + 1e-30)


def test_expand_3d_matches_jax():
    rng = np.random.default_rng(0)
    movie = rng.uniform(0.0, 1.0, (3, 10, 12)).astype(np.float32)
    for H_r in (0.1, 0.0):
        port = utils.expand_3d(torch.as_tensor(movie), fov_xy=FOV,
                               fov_z=4.0, H_r=H_r, nz=8)
        ref = j_utils.expand_3d(movie, fov_xy=FOV, fov_z=4.0, H_r=H_r, nz=8)
        assert (port.start, port.stop) == (ref.start, ref.stop)
        _close_to_max(port.data.numpy(), ref.data, 1e-5)


@pytest.mark.parametrize('shape', [(2, 12, 12), (9, 7), (2, 3, 6, 10)])
def test_fft_transform_matches_jax(shape):
    """The padded, shifted FFT, odd and even sides and extra leading
    axes (the shifts run over every axis in both packages)."""
    movie = np.random.default_rng(1).standard_normal(shape).astype(
        np.float32)
    port = utils.fft_transform(torch.as_tensor(movie))
    ref = np.asarray(j_utils.fft_transform(movie))
    assert port.dtype == torch.complex64
    _close_to_max(port.numpy(), ref, 1e-5)
    assert utils.next_power_of_two(33) == j_utils.next_power_of_two(33) == 64


def test_anti_aliasing_filter_matches_jax():
    rng = np.random.default_rng(2)
    image = rng.standard_normal((3, 16, 16)).astype(np.float32)
    x = np.linspace(-1, 1, 16)
    window = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / 0.1).astype(
        np.float32)
    port = utils.anti_aliasing_filter(torch.as_tensor(image),
                                      torch.as_tensor(window))
    ref = j_utils.anti_aliasing_filter(image, window)
    _close_to_max(port.numpy(), ref, 1e-5)


def _jax_draws(key, shape):
    """The complex draws of bhnerf_tpu/utils.py:280-301 rebuilt from its
    key: one per frame, each the real then the imaginary normals."""
    def complex_noise(k):
        k_re, k_im = jr.split(k)
        return (np.asarray(jr.normal(k_re, shape[-2:]))
                + 1j * np.asarray(jr.normal(k_im, shape[-2:])))
    if len(shape) == 2:
        return complex_noise(key)
    return np.stack([complex_noise(k) for k in jr.split(key, shape[0])])


@pytest.mark.parametrize('shape,kw', [
    ((16, 12), dict(slope=3.0)),
    ((5, 12, 16), dict(slope=2.5, std=0.7, temporal_corr=0.8)),
    ((4, 8, 8), dict(temporal_corr=0.0))])
def test_grf_noise_map_matches_jax(shape, kw):
    """grf_from_noise of the JAX package's own draws equals its
    gaussian_random_field, both in float64 (the JAX package under x64),
    within 1e-10."""
    with jax.enable_x64(True):
        key = jr.PRNGKey(3)
        ref = np.asarray(j_utils.gaussian_random_field(key, shape, **kw))
        noise = _jax_draws(key, shape)
    assert ref.dtype == np.float64
    port = utils.grf_from_noise(torch.as_tensor(noise), **kw)
    assert port.dtype == torch.float64
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-10)


def test_grf_statistics():
    """The checks of tests/test_review_regressions.py::test_grf_statistics
    on the port's field from a torch.Generator: unit standard deviation,
    not point-symmetric, AR(1) frames correlated by temporal_corr."""
    gen = lambda: torch.Generator().manual_seed(0)
    f = utils.gaussian_random_field(gen(), (64, 64), slope=3.0).numpy()
    assert f.dtype == np.float32
    assert abs(f.std() - 1.0) < 1e-3
    corr = np.corrcoef(f.ravel(), np.flip(f).ravel())[0, 1]
    assert abs(corr) < 0.9
    m = utils.gaussian_random_field(gen(), (6, 32, 32),
                                    temporal_corr=0.95).numpy()
    cc = [np.corrcoef(m[i].ravel(), m[i + 1].ravel())[0, 1]
          for i in range(5)]
    assert np.mean(cc) > 0.7
    m0 = utils.gaussian_random_field(gen(), (6, 32, 32),
                                     temporal_corr=0.0).numpy()
    cc0 = [np.corrcoef(m0[i].ravel(), m0[i + 1].ravel())[0, 1]
           for i in range(5)]
    assert np.mean(cc0) < 0.3
    again = utils.gaussian_random_field(gen(), (6, 32, 32),
                                        temporal_corr=0.0).numpy()
    np.testing.assert_array_equal(again, m0)


def test_propogate_flatspace_emission_matches_jax():
    """A hotspot advected by a Keplerian Omega over 5 frames in M, with
    the default start and with a later one, within 5e-5 of the max."""
    field = utils.gaussian_field((12, 12, 10), [4.0, 1.0, 0.0], 1.5,
                                 fov=FOV)
    j_field = j_utils.Grid3D(field.data.numpy(), field.start, field.stop)
    x, y, z = field.meshgrid()
    r = np.sqrt(x**2 + y**2 + z**2) + 2.0
    omega = 1.0 / (r ** 1.5)
    t_frames = np.linspace(10.0, 60.0, 5)
    for t_start in (None, 30.0):
        port = emission.propogate_flatspace_emission(
            field, omega, t_frames, t_start_obs=t_start, device='cpu')
        ref = j_emission.propogate_flatspace_emission(
            j_field, omega, t_frames, t_start_obs=t_start)
        _close_to_max(port.numpy(), ref, 5e-5)
        if t_start is not None:
            assert (port[:2] == 0).all()


@pytest.fixture(scope='module')
def tables(tmp_path_factory):
    """An 8x8x24 table of the port's host tracer, and the JAX package's
    Geodesics read from its npz."""
    geos = image_plane_geos(spin=0.3, inclination=np.deg2rad(50.0),
                            alpha_range=(-FOV / 2, FOV / 2),
                            beta_range=(-FOV / 2, FOV / 2), ngeo=24,
                            num_alpha=8, num_beta=8, n_fine=512)
    path = tmp_path_factory.mktemp('tables') / 'geos.npz'
    geos.save(path)
    return geos, JGeodesics.load(path)


@pytest.mark.parametrize('frames', [2, 0], ids=['movie', 'one-field'])
def test_grf_to_image_plane_matches_jax(tables, frames):
    """A random-field disk through the table, Stokes factors per sample,
    as a 2-frame movie and as one field, within 5e-5 of the max."""
    geos, j_geos = tables
    rng = np.random.default_rng(4)
    grf = rng.standard_normal((frames, 16, 16) if frames else (16, 16))
    J = rng.uniform(-1.0, 1.0, (3, *geos.r.shape))
    omega = geos.keplerian_omega()
    port = emission.grf_to_image_plane(grf, geos, omega, J, diameter_M=8.0,
                                       device='cpu')
    ref = j_emission.grf_to_image_plane(grf.astype(np.float32), j_geos,
                                        np.asarray(j_geos.keplerian_omega()),
                                        J.astype(np.float32), diameter_M=8.0)
    assert port.shape == ((frames,) if frames else ()) + (3, 8, 8)
    _close_to_max(port.numpy(), ref, 5e-5)
