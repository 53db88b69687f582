"""The reference's calling convention of emission.velocity_warp_coords in
bhnerf_tpu_torch: the default call returns the warped coordinates alone
with NaN before injection, `fill_nan=False` returns them without the NaN,
and `return_mask=True` returns (coords, valid) NaN-free (counterparts of
tests/test_forward_model.py:60-85, and the JAX package's function on the
same seeded inputs).

Tolerances: coordinates within 1e-5 M (atol) of the JAX package's float32
ones, NaN at exactly the same positions, the masks equal.
"""
import numpy as np
import pytest

from bhnerf_tpu import emission as j_emission

import torch

from bhnerf_tpu_torch import emission


def test_velocity_warp_rotates_back():
    """A point at angle Omega*t warps back to its t=0 position."""
    Omega, t = 0.1, 5.0
    ang = Omega * t
    pt = np.array([[6 * np.cos(ang)], [6 * np.sin(ang)], [0.0]])
    warped = emission.velocity_warp_coords(
        pt, Omega, t_frames=t, t_start_obs=0.0, t_geos=0.0, t_injection=0.0)
    assert isinstance(warped, torch.Tensor)
    np.testing.assert_allclose(warped.numpy()[..., :2].ravel(), [6.0, 0.0],
                               atol=1e-4)


def test_velocity_warp_pre_injection_masked():
    """Before injection: return_mask=True gives an all-False mask and
    finite coordinates; the default call gives NaN everywhere."""
    coords = np.ones((3, 4))
    warped, valid = emission.velocity_warp_coords(
        coords, 0.1, t_frames=1.0, t_start_obs=0.0, t_geos=0.0,
        t_injection=5.0, return_mask=True)
    assert not valid.numpy().any()
    assert np.isfinite(warped.numpy()).all()
    warped_nan = emission.velocity_warp_coords(
        coords, 0.1, t_frames=1.0, t_start_obs=0.0, t_geos=0.0,
        t_injection=5.0)
    assert np.isnan(warped_nan.numpy()).all()


def _inputs():
    """Coordinates (3, 4, 5), a per-sample Omega and t_geos, and 3 frames
    whose injection cut leaves part of every frame valid."""
    rng = np.random.default_rng(7)
    coords = rng.uniform(-10, 10, (3, 4, 5)).astype(np.float32)
    Omega = rng.uniform(0.01, 0.1, (4, 5)).astype(np.float32)
    t_geos = rng.uniform(-30, 0, (4, 5)).astype(np.float32)
    t_frames = np.array([0.0, 10.0, 25.0], np.float32)
    return coords, Omega, t_frames, t_geos, -12.0


@pytest.mark.parametrize('kwargs', [{}, {'fill_nan': False},
                                    {'return_mask': True},
                                    {'fill_nan': False, 'return_mask': True}],
                         ids=['default', 'no_fill', 'mask', 'no_fill_mask'])
def test_velocity_warp_matches_jax(kwargs):
    coords, Omega, t_frames, t_geos, t_inj = _inputs()
    ref = j_emission.velocity_warp_coords(coords, Omega, t_frames, 0.0,
                                          t_geos, t_inj, **kwargs)
    got = emission.velocity_warp_coords(
        torch.as_tensor(coords), torch.as_tensor(Omega),
        torch.as_tensor(t_frames), 0.0, torch.as_tensor(t_geos), t_inj,
        **kwargs)
    if kwargs.get('return_mask'):
        (ref, ref_valid), (got, got_valid) = ref, got
        np.testing.assert_array_equal(got_valid.numpy(),
                                      np.asarray(ref_valid))
        assert 0 < got_valid.numpy().sum() < got_valid.numel()
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape == (3, 4, 5, 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    if kwargs:
        assert np.isfinite(got).all()
    else:
        assert np.isnan(got).any()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
