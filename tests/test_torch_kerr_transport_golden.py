"""Golden validation of the port's Kerr geodesic transport at spin 0.94:
the counterpart of tests/test_kerr_transport_golden.py on
bhnerf_tpu_torch's host float64 trace.

A few rays are re-integrated by a method that shares nothing with the
tracer's second-order Mino-time formulation but the metric: Hamilton's
equations of the Kerr metric,

    dx/dl = g^{munu} p_nu,   dp/dl = -1/2 d_mu g^{alphabeta} p_a p_b,

with the metric-derivative term from torch.autograd of the scalar
H = 1/2 g^{ab} p_a p_b in float64 (the reference file takes jax.grad),
integrated by scipy's RK45 at rtol 1e-11 and evaluated at the table's
Mino times through d/dtau = Sigma d/dl. The rays, sizes and bars are the
reference file's.
"""
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from bhnerf_tpu_torch.geodesics import trace_geodesics

SPIN = 0.94
INC = np.deg2rad(60.0)


def kerr_inverse_metric(x, a):
    """Contravariant Kerr metric in BL coordinates (G=c=M=1)."""
    t, r, th, ph = x
    s2 = torch.sin(th) ** 2
    Sigma = r**2 + a**2 * torch.cos(th) ** 2
    Delta = r**2 - 2.0 * r + a**2
    Xi = (r**2 + a**2) ** 2 - a**2 * Delta * s2
    g_tt = -Xi / (Sigma * Delta)
    g_tp = -2.0 * a * r / (Sigma * Delta)
    g_pp = (Delta - a**2 * s2) / (Sigma * Delta * s2)
    g_rr = Delta / Sigma
    g_thth = 1.0 / Sigma
    return g_tt, g_tp, g_pp, g_rr, g_thth


def hamiltonian(x, p, a):
    g_tt, g_tp, g_pp, g_rr, g_thth = kerr_inverse_metric(x, a)
    return 0.5 * (g_tt * p[0] ** 2 + 2 * g_tp * p[0] * p[3]
                  + g_pp * p[3] ** 2 + g_rr * p[1] ** 2
                  + g_thth * p[2] ** 2)


def ham_rhs(y, a, direction):
    """d(x, p)/dtau of Hamilton's equations, times Sigma."""
    y = torch.as_tensor(y, dtype=torch.float64)
    x = y[:4].clone().requires_grad_(True)
    p = y[4:8]
    (dHdx,) = torch.autograd.grad(hamiltonian(x, p, a), x)
    x = x.detach()
    g_tt, g_tp, g_pp, g_rr, g_thth = kerr_inverse_metric(x, a)
    dx = torch.stack([g_tt * p[0] + g_tp * p[3], g_rr * p[1],
                      g_thth * p[2], g_tp * p[0] + g_pp * p[3]])
    Sigma = x[1] ** 2 + a**2 * torch.cos(x[2]) ** 2
    return (direction * Sigma * torch.cat([dx, -dHdx])).numpy()


@pytest.fixture(scope='module')
def geos():
    # rays probing the strong field: inside and outside the critical curve
    # and a high-latitude ray
    alpha = np.array([-6.0, 3.0, 5.5, 1.0])
    beta = np.array([0.5, 2.0, -3.0, 6.0])
    return trace_geodesics(alpha, beta, SPIN, INC, ngeo=64, n_fine=8192)


def _initial_conditions(geos, k):
    """(x0, p0, direction) at sample 0 of ray k, signs fixed empirically
    from the first Mino step (so the test does not inherit the tracer's
    sign bookkeeping)."""
    r0 = geos.r[k, 0]
    th0 = geos.theta[k, 0]
    x0 = np.array([geos.t[k, 0], r0, th0, geos.phi[k, 0]])
    lam, eta = geos.lam[k], geos.eta[k]
    a = geos.spin
    Delta = r0**2 - 2 * r0 + a**2
    R = ((r0**2 + a**2 - a * lam) ** 2
         - Delta * (eta + (lam - a) ** 2))
    Theta = eta + a**2 * np.cos(th0) ** 2 \
        - lam**2 * np.cos(th0) ** 2 / np.sin(th0) ** 2
    p_r = np.sqrt(max(R, 0.0)) / Delta
    p_th = np.sqrt(max(Theta, 0.0))
    p0 = np.array([-1.0, p_r, p_th, lam])

    Sigma = r0**2 + a**2 * np.cos(th0) ** 2
    s2 = np.sin(th0) ** 2
    Xi = (r0**2 + a**2) ** 2 - a**2 * Delta * s2
    dt_dtau = Sigma * (-(-Xi / (Sigma * Delta)) * 1.0
                       + (-2 * a * r0 / (Sigma * Delta)) * lam)
    direction = 1.0 if dt_dtau * (geos.t[k, 1] - geos.t[k, 0]) > 0 \
        else -1.0
    if direction * (geos.r[k, 1] - geos.r[k, 0]) < 0:
        p0[1] = -p0[1]
    if direction * (geos.theta[k, 1] - geos.theta[k, 0]) < 0:
        p0[2] = -p0[2]
    return x0, p0, direction


@pytest.fixture(scope='module')
def ham_solutions(geos):
    """One high-accuracy Hamiltonian integration per ray, shared by the
    transport and affine-weight goldens; the 9th state integrates Sigma
    for the affine arc."""
    a = geos.spin
    sols = []
    for k in range(geos.r.shape[0]):
        x0, p0, direction = _initial_conditions(geos, k)
        taus = geos.mino[k]

        def rhs_with_affine(tau, y, direction=direction):
            core = ham_rhs(y[:8], a, direction)
            Sigma = y[1] ** 2 + a**2 * np.cos(y[2]) ** 2
            return np.concatenate([core, [Sigma]])

        sol = solve_ivp(rhs_with_affine, (0.0, taus[-1]),
                        np.concatenate([x0, p0, [0.0]]), t_eval=taus,
                        rtol=1e-11, atol=1e-12, method='RK45')
        assert sol.success
        sols.append(sol)
    return sols


def test_transport_matches_hamiltonian_integration(geos, ham_solutions):
    """t, phi, r, theta along each ray match the Hamiltonian reference in
    the strong field (r < 100: t to 1e-6 of its scale, r 1e-3, theta
    2e-6, phi 1e-5 rad) and t to 1e-2 relative on the far-field tail, at
    the table's own Mino times."""
    a = geos.spin
    for k in range(geos.r.shape[0]):
        sol = ham_solutions[k]
        t_ref, r_ref, th_ref, ph_ref = sol.y[0], sol.y[1], sol.y[2], \
            sol.y[3]
        t_scale = max(np.abs(t_ref).max(), 1.0)
        # the escaping far-field tail amplifies any Mino-time error by
        # Sigma ~ r^2 through dt/dtau and carries no emission
        sf = r_ref < 100.0
        np.testing.assert_allclose(geos.t[k][sf], t_ref[sf],
                                   atol=1e-6 * t_scale,
                                   err_msg=f'ray {k}: t')
        np.testing.assert_allclose(geos.r[k][sf], r_ref[sf], atol=1e-3,
                                   err_msg=f'ray {k}: r')
        np.testing.assert_allclose(geos.theta[k][sf], th_ref[sf],
                                   atol=2e-6, err_msg=f'ray {k}: theta')
        np.testing.assert_allclose(geos.phi[k][sf], ph_ref[sf], atol=1e-5,
                                   err_msg=f'ray {k}: phi')
        np.testing.assert_allclose(geos.t[k], t_ref,
                                   rtol=1e-2, atol=1e-6 * t_scale,
                                   err_msg=f'ray {k}: t (tail)')
        # the null condition of the reference solution holds to
        # solve_ivp's own drift
        H_end = float(hamiltonian(torch.as_tensor(sol.y[:4, -1]),
                                  torch.as_tensor(sol.y[4:8, -1]), a))
        assert abs(H_end) < 1e-3


def test_dtau_is_mino_step(geos):
    """dtau (the radiative-transfer weight) is the per-sample Mino step of
    the uniform two-pass sampling."""
    dm = np.diff(geos.mino, axis=-1)
    np.testing.assert_allclose(geos.dtau[:, 1:], dm, rtol=1e-10)


def test_strong_field_affine_weights_match_hamiltonian(geos,
                                                       ham_solutions):
    """The trapezoid of the table's Sigma over its Mino grid matches the
    Hamiltonian integration's affine arc between consecutive samples to
    5% inside the emission region (r < 20)."""
    for k in range(geos.r.shape[0]):
        sol = ham_solutions[k]
        d_affine_ref = np.diff(sol.y[8])
        sig = geos.Sigma[k]
        w_ds = 0.5 * (sig[1:] + sig[:-1]) * np.diff(geos.mino[k])
        inside = (geos.r[k][1:] < 20.0) & (sol.y[1][1:] < 20.0) \
            & (geos.r[k][:-1] < 20.0)
        if inside.sum() < 3:
            continue
        np.testing.assert_allclose(w_ds[inside], d_affine_ref[inside],
                                   rtol=5e-2, err_msg=f'ray {k}')
