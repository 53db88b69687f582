"""The reference's physics checks of equatorial lensing on the port
(tests/test_polarization_physics.py:26-43) and rho_of_req with the
float32 device trace (backend='device', device='cpu': the tracer
kernel's plain version) against the host float64 trace.

Small sizes, as the port's host tracer is a Python loop whose cost is per
step (~1.5 s a trace here): few azimuths, 5 bisection steps (7 traces a
rho_of_req), n_fine 512, 48-64 samples a ray. The bisection then
resolves rho to (rho_max - rho_min) / 47 / 2^5 = 7.3e-3 M.
"""
import numpy as np
import pytest

from bhnerf_tpu_torch.geodesics import equatorial

N_FINE = 512
ITERS = 5
BRACKET = (12.0 - 1.0) / 47 / 2**ITERS
FACE_ON = np.deg2rad(0.01)


@pytest.fixture(scope='module')
def face_on():
    """rho_of_req(0, 0.01 deg, 6 M) over 3 azimuths, host float64 and
    device float32 (its plain version on the CPU)."""
    kw = dict(mbar=0, varphis=np.linspace(-np.pi, np.pi, 3, endpoint=False),
              ngeo=48, iters=ITERS, n_fine=N_FINE)
    out = {}
    for backend in ('cpu', 'device'):
        _, out[backend] = equatorial.rho_of_req(0.0, FACE_ON, 6.0,
                                                backend=backend,
                                                device='cpu', **kw)
    out['varphis'] = kw['varphis']
    return out


def test_face_on_ring_is_circular(face_on):
    """Nearly face-on Schwarzschild: the lensed ring is circular, and weak
    lensing pushes it outside the emission radius."""
    rho = face_on['cpu']
    assert rho.std() / rho.mean() < 1e-3
    assert (rho > 6.0).all() and (rho < 9.0).all()


def test_device_trace_roots_match_host(face_on):
    """The float32 trace finds every root within two bisection brackets of
    the float64 one, and its roots pass the reference's own re-trace check
    on the host float64 trace (|r - req| <= 1e-2 req)."""
    rho, rho_dev = face_on['cpu'], face_on['device']
    assert np.isfinite(rho_dev).all()
    np.testing.assert_array_less(np.abs(rho_dev - rho), 2 * BRACKET)
    phis = face_on['varphis']
    r, _ = equatorial.r_equatorial(0.0, np.inf, FACE_ON, 0,
                                   rho_dev * np.cos(phis),
                                   rho_dev * np.sin(phis), ngeo=48,
                                   n_fine=N_FINE)
    np.testing.assert_array_less(np.abs(r - 6.0), 6e-2)


def test_first_order_ring_near_critical_curve():
    """The mbar = 1 image of an equatorial radius hugs the photon ring
    (b_c = sqrt(27) for Schwarzschild)."""
    _, rho = equatorial.rho_of_req(
        0.0, FACE_ON, 6.0, mbar=1,
        varphis=np.linspace(-np.pi, np.pi, 2, endpoint=False), ngeo=64,
        iters=ITERS, n_fine=N_FINE)
    assert np.isfinite(rho).all()
    assert np.abs(rho - np.sqrt(27.0)).max() < 0.35
