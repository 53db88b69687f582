"""Port parity for equatorial lensing: the Kerr functions of
bhnerf_tpu_torch.geodesics.kerr, crossing detection
(geodesics.equatorial, emission.equatorial_ring) and the inversion
r_equatorial / rho_of_req, against bhnerf_tpu.

The Kerr functions are held at rtol 1e-12 in float64 (the JAX package
under x64). Crossings are detected in numpy on one table, crossed from
the port to the JAX package as npz, and must be exactly equal. The
traced functions are held to the tolerance tests/test_torch_geodesics.py
holds the host tables to (1e-12 of the largest value; both packages
integrate the same RK4 in float64), NaN in the same places. The JAX
package traces at trace_geodesics' default n_fine 8192, which the port's
host loop cannot afford 10 times in a test: its trace_geodesics runs at
N_FINE here, as the port's is called with n_fine=N_FINE.
"""
import contextlib

import numpy as np
import pytest

import jax

from bhnerf_tpu import emission as j_emission
from bhnerf_tpu.geodesics import dataset as j_dataset
from bhnerf_tpu.geodesics import equatorial as j_equatorial
from bhnerf_tpu.geodesics import kerr as j_kerr
from bhnerf_tpu.geodesics.dataset import Geodesics as JGeodesics

import torch

from bhnerf_tpu_torch import emission
from bhnerf_tpu_torch.geodesics import equatorial, kerr, trace_geodesics
from bhnerf_tpu_torch.geodesics.dataset import Geodesics

N_FINE = 512
INC = np.deg2rad(20.0)
# rho_of_req at a small size: few azimuths, 8 bisection steps (10 traces)
RHO_KW = dict(varphis=np.linspace(-np.pi, np.pi, 4, endpoint=False),
              iters=8, ngeo=48)


@contextlib.contextmanager
def jax_trace_at(**trace):
    """Inside this scope the JAX package's trace_geodesics (the one its
    equatorial module calls) traces with `trace` in place of the caller's
    arguments."""
    original = j_dataset.trace_geodesics

    def forced(*args, **kwargs):
        return original(*args, **{**kwargs, **trace})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_dataset, 'trace_geodesics', forced)
        yield


def _points(shape=(40,)):
    rng = np.random.default_rng(0)
    return dict(r=rng.uniform(2.0, 30.0, shape),
                theta=rng.uniform(0.05, np.pi - 0.05, shape),
                alpha=rng.uniform(-10.0, 10.0, shape),
                beta=rng.uniform(-10.0, 10.0, shape))


@pytest.mark.parametrize('kind', ['numpy', 'torch'])
def test_kerr_functions_match_jax(kind):
    """conserved_quantities, Delta, Sigma, Xi, omega, R and Theta
    potentials and keplerian_omega at rtol 1e-12, on numpy arrays and on
    float64 tensors."""
    p = _points()
    spin, inc = 0.7, 1.1
    conv = (lambda x: x) if kind == 'numpy' else torch.as_tensor
    back = np.asarray if kind == 'numpy' else (lambda x: x.numpy())
    r, theta, alpha, beta = (conv(p[k]) for k in ('r', 'theta', 'alpha',
                                                  'beta'))
    lam, eta = kerr.conserved_quantities(alpha, beta, spin, inc)
    with jax.enable_x64(True):
        j_lam, j_eta = j_kerr.conserved_quantities(p['alpha'], p['beta'],
                                                   spin, inc)
        pairs = {
            'lam': (lam, j_lam), 'eta': (eta, j_eta),
            'Delta': (kerr.Delta(r, spin), j_kerr.Delta(p['r'], spin)),
            'Sigma': (kerr.Sigma(r, theta, spin),
                      j_kerr.Sigma(p['r'], p['theta'], spin)),
            'Xi': (kerr.Xi(r, theta, spin),
                   j_kerr.Xi(p['r'], p['theta'], spin)),
            'omega': (kerr.omega(r, theta, spin),
                      j_kerr.omega(p['r'], p['theta'], spin)),
            'R': (kerr.R_potential(r, spin, lam, eta),
                  j_kerr.R_potential(p['r'], spin, j_lam, j_eta)),
            'Theta': (kerr.Theta_potential(theta, spin, lam, eta),
                      j_kerr.Theta_potential(p['theta'], spin, j_lam,
                                             j_eta)),
            'keplerian': (kerr.keplerian_omega(r, spin, direction=-1.0,
                                               frac=0.8),
                          j_kerr.keplerian_omega(p['r'], spin,
                                                 direction=-1.0, frac=0.8)),
        }
        for name, (port, ref) in pairs.items():
            ref = np.asarray(ref)
            assert ref.dtype == np.float64, name
            if kind == 'torch':
                assert isinstance(port, torch.Tensor), name
            np.testing.assert_allclose(back(port), ref, rtol=1e-12,
                                       atol=0, err_msg=name)


@pytest.fixture(scope='module')
def table(tmp_path_factory):
    """A (4, 6)-ray screen of the port's host trace (spin 0.5, 30 deg,
    the screen radii 2-9 M of tests/test_polarization_physics.py's
    emission-map test), and the JAX package's Geodesics read from its
    npz."""
    alpha = np.linspace(-9.0, 9.0, 24).reshape(4, 6)
    beta = np.linspace(-3.0, 4.0, 24)[::-1].reshape(4, 6)
    geos = trace_geodesics(alpha, beta, 0.5, np.deg2rad(30.0), ngeo=128,
                           n_fine=N_FINE)
    path = tmp_path_factory.mktemp('equatorial') / 'geos.npz'
    geos.save(path)
    return geos, JGeodesics.load(path)


def test_geodesics_properties_call_kerr(table):
    """The table's metric properties are kerr's functions of its arrays."""
    geos, _ = table
    np.testing.assert_array_equal(geos.Xi, kerr.Xi(geos.r, geos.theta,
                                                   geos.spin))
    np.testing.assert_array_equal(geos.omega, kerr.omega(geos.r, geos.theta,
                                                         geos.spin))
    np.testing.assert_array_equal(geos.keplerian_omega(-1.0, 0.5),
                                  kerr.keplerian_omega(geos.r, geos.spin,
                                                       1.0, -1.0, 0.5))
    np.testing.assert_array_equal(geos.Theta, kerr.Theta_potential(
        geos.theta, geos.spin, geos.lam[..., None], geos.eta[..., None]))


@pytest.mark.parametrize('mbar', [0, 1, 2])
def test_crossings_equal_jax(table, mbar):
    """crossing_index, equatorial_crossing_quantities and equatorial_ring
    of both packages on the same table: exactly equal, NaN in the same
    places."""
    geos, j_geos = table
    for port, ref in zip(equatorial.crossing_index(geos, mbar),
                         j_equatorial.crossing_index(j_geos, mbar)):
        np.testing.assert_array_equal(port, np.asarray(ref))
    port = equatorial.equatorial_crossing_quantities(geos, mbar)
    ref = j_equatorial.equatorial_crossing_quantities(j_geos, mbar)
    assert set(port) == set(ref)
    for k in port:
        np.testing.assert_array_equal(port[k], np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(emission.equatorial_ring(geos, mbar),
                                  j_emission.equatorial_ring(j_geos, mbar))


def test_equatorial_ring_emission_map():
    """tests/test_polarization_physics.py::test_equatorial_ring_emission_map
    on the port: one unit sample per crossing ray, zero elsewhere."""
    b = np.linspace(2.0, 9.0, 12)
    geos = trace_geodesics(b, np.zeros_like(b), spin=0.0,
                           inclination=np.deg2rad(30.0), ngeo=128,
                           n_fine=N_FINE)
    ring = emission.equatorial_ring(geos, mbar=0)
    per_ray = ring.sum(axis=-1)
    assert set(np.unique(per_ray)) <= {0.0, 1.0}
    assert per_ray.sum() >= 10


def _nan_equal_close(port, ref, rel=1e-12):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    ok = ~np.isnan(ref)
    if ok.any():
        scale = np.abs(ref[ok]).max()
        np.testing.assert_allclose(port[ok], ref[ok], rtol=0,
                                   atol=rel * scale)


def test_r_equatorial_matches_jax():
    """r_equatorial for mbar 0 and 1 over screen points inside and
    outside the existence window of the crossing, some near the critical
    curve, where the second crossing exists."""
    alpha = np.array([1.5, 3.0, 5.0, 6.5, 9.0, -4.0, 0.2, 5.6, 0.3, -3.9])
    beta = np.array([0.0, 2.0, -1.0, 3.0, 0.5, -5.0, 7.5, 0.0, 5.5, -3.9])
    for mbar in (0, 1):
        r, mino = equatorial.r_equatorial(0.6, np.inf, INC, mbar, alpha,
                                          beta, ngeo=64, n_fine=N_FINE)
        with jax_trace_at(n_fine=N_FINE):
            j_r, j_mino = j_equatorial.r_equatorial(0.6, np.inf, INC, mbar,
                                                    alpha, beta, ngeo=64)
        _nan_equal_close(r, j_r)
        _nan_equal_close(mino, j_mino)
        assert np.isfinite(r).sum() >= (5 if mbar == 0 else 1)


@pytest.fixture(scope='module')
def rho_pair():
    """rho_of_req(0, 20 deg, 6) of both packages at RHO_KW."""
    _, rho = equatorial.rho_of_req(0.0, INC, 6.0, n_fine=N_FINE, **RHO_KW)
    with jax_trace_at(n_fine=N_FINE):
        _, j_rho = j_equatorial.rho_of_req(0.0, INC, 6.0, **RHO_KW)
    return rho, np.asarray(j_rho)


def test_rho_of_req_matches_jax(rho_pair):
    rho, j_rho = rho_pair
    assert np.isfinite(rho).all()
    _nan_equal_close(rho, j_rho)


def test_equatorial_crossing_self_consistency(rho_pair):
    """tests/test_polarization_physics.py::
    test_equatorial_crossing_self_consistency on the port: the rays through
    rho_of_req's roots cross the equator at req (rtol 5e-3)."""
    rho, _ = rho_pair
    phis = RHO_KW['varphis']
    r_cross, _ = equatorial.r_equatorial(
        0.0, np.inf, INC, 0, rho * np.cos(phis), rho * np.sin(phis),
        ngeo=RHO_KW['ngeo'], n_fine=N_FINE)
    np.testing.assert_allclose(r_cross, 6.0, rtol=5e-3)


def test_rho_of_req_unreachable_returns_nan():
    """tests/test_review_regressions.py::
    test_rho_of_req_unreachable_returns_nan on both packages: no root below
    rho_max for req = 50 M, so NaN (one bisection step suffices: the
    bracket test decides)."""
    kw = dict(mbar=0, varphis=np.array([0.0, 1.0]), rho_max=10.0, ngeo=32,
              iters=1)
    _, rho = equatorial.rho_of_req(0.0, INC, 50.0, n_fine=N_FINE, **kw)
    with jax_trace_at(n_fine=N_FINE):
        _, j_rho = j_equatorial.rho_of_req(0.0, INC, 50.0, **kw)
    assert np.isnan(rho).all() and np.isnan(np.asarray(j_rho)).all()


def test_traces_go_through_trace_geodesics(monkeypatch):
    """r_equatorial passes backend, device and n_fine to trace_geodesics
    and rho_of_req makes 1 + iters + 1 traces."""
    from bhnerf_tpu_torch.geodesics import dataset
    calls = []
    original = dataset.trace_geodesics

    def spy(*args, **kwargs):
        calls.append({k: kwargs[k] for k in ('backend', 'device', 'n_fine',
                                             'ngeo')})
        return original(*args, **{**kwargs, 'n_fine': 64})

    monkeypatch.setattr(dataset, 'trace_geodesics', spy)
    equatorial.rho_of_req(0.0, INC, 6.0, varphis=np.array([0.5]), iters=2,
                          ngeo=8, backend='device', device='cpu',
                          n_fine=1234)
    assert calls == [dict(backend='device', device='cpu', n_fine=1234,
                          ngeo=8)] * 4
    assert Geodesics is dataset.Geodesics
