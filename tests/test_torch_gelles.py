"""The Gelles2021 polarized ring of bhnerf_tpu_torch.examples
(ring_stokes, its golden face-on checks) and visualization.
plot_evpa_ticks, against the JAX package's example
(examples/gelles2021_polarized_ring.py).

ring_stokes traces rho_of_req's 1 + 40 + 1 tables and its ring at 400
samples and n_fine 8192; the port's host tracer is a Python loop whose
cost is per step, so here both packages trace at TRACE and bisect ITERS
times (their trace_geodesics and rho_of_req are patched for the call).
Both integrate the same RK4 in float64 and the JAX package's transport
physics runs under x64 here (in float32 it is 1e-5 off, as the ALMA
model's, tests/test_torch_alma.py), so the Stokes factors agree to 1e-9
of their largest value.
"""
import contextlib
import importlib.util
import os

import numpy as np
import pytest

import jax

import bhnerf_tpu.geodesics as j_geodesics
from bhnerf_tpu.geodesics import dataset as j_dataset
from bhnerf_tpu.geodesics import equatorial as j_equatorial

from bhnerf_tpu_torch.examples import gelles2021_polarized_ring as gelles
from bhnerf_tpu_torch.geodesics import dataset, equatorial

TRACE = dict(n_fine=256, ngeo=48)
ITERS = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _forced(fn, **fixed):
    return lambda *args, **kwargs: fn(*args, **{**kwargs, **fixed})


@contextlib.contextmanager
def small_traces():
    """Both packages' traces at TRACE and their rho_of_req at ITERS."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (dataset, j_dataset, j_geodesics):
            mp.setattr(module, 'trace_geodesics',
                       _forced(module.trace_geodesics, **TRACE))
        for module in (equatorial, j_equatorial):
            mp.setattr(module, 'rho_of_req',
                       _forced(module.rho_of_req, iters=ITERS))
        yield


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        'j_gelles', os.path.join(REPO, 'examples',
                                 'gelles2021_polarized_ring.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ring_stokes_matches_jax():
    """A boosted emitter in a tilted field at 20 deg, 3 azimuths, in both
    packages."""
    kw = dict(spin=0.3, inc_deg=20.0, req=6.0, beta_v=0.4, chi_deg=-90.0,
              b_field=[0.0, 0.71, 0.71], nphi=3)
    with small_traces():
        port = gelles.ring_stokes(**kw)
        with jax.enable_x64(True):
            ref = _jax_example().ring_stokes(**kw)
    for name, p, r in zip(('varphis', 'alpha', 'beta', 'stokes'), port,
                          ref):
        r = np.asarray(r)
        assert p.shape == r.shape, name
        assert np.isfinite(p).all(), name
        np.testing.assert_allclose(p, r, rtol=0,
                                   atol=1e-9 * np.abs(r).max(), err_msg=name)
    assert np.abs(port[3][0]).min() > 0


def test_golden_face_on_checks():
    """The example's face-on checks at 4 azimuths: radial B gives
    azimuthal ticks, toroidal B radial ticks (within 3 deg), vertical B
    under 0.2 of the radial case's intensity."""
    with small_traces():
        out = gelles.golden_face_on(nphi=4, backend='cpu')
    assert out['radial_evpa_dev'] < np.deg2rad(3)
    assert out['toroidal_evpa_dev'] < np.deg2rad(3)
    assert 0 <= out['vertical_I_ratio'] < 0.2


def test_plot_evpa_ticks_draws_the_ticks():
    """One headless tick per point, of length sqrt(Q^2 + U^2) along the
    EVPA East of North."""
    matplotlib = pytest.importorskip('matplotlib')
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from bhnerf_tpu_torch.visualization import plot_evpa_ticks
    Q, U = np.array([1.0, 0.0, -0.5]), np.array([0.0, 2.0, 0.0])
    ax = plot_evpa_ticks(Q, U, np.arange(3.0), np.zeros(3), color='k')
    (quiver,) = ax.collections
    np.testing.assert_allclose(quiver.U, [0.0, -np.sqrt(2), -0.5],
                               atol=1e-12)
    np.testing.assert_allclose(quiver.V, [1.0, np.sqrt(2), 0.0], atol=1e-12)
    plt.close('all')
