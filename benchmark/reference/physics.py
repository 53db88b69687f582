"""Ray constants of the benchmark's configurations in numpy float64.

A frozen copy of the port's host physics: the Boyer-Lindquist metric, the
photon wave vector, Keplerian flow, the Doppler factor, the fluid-frame
tetrad and magnetic field and the Stokes parallel transport
(`ops/gr.py` of bhnerf_tpu_torch), the ALMA model block's physics
(`alma._model_physics`), the EVPA rotation (`emission.rotate_evpa`) and
the constants (`constants.py`). `Rays` stands in for the port's
`Geodesics` container over the traced rays of `geodesics.trace`.
"""
from __future__ import annotations

import numpy as np

from benchmark.reference import geodesics as kerr

G = 6.6743e-11
C = 2.99792458e8
M_SUN = 1.98892e30
SGRA_MASS_KG = 4.154e6 * M_SUN


def gm_c3_hours():
    """One gravitational time of Sgr A* in hours."""
    return G * SGRA_MASS_KG / C**3 / 3600.0


def isco_pro(a):
    z1 = 1 + (1 - a**2) ** (1 / 3) * ((1 + a) ** (1 / 3) + (1 - a) ** (1 / 3))
    z2 = np.sqrt(3 * a**2 + z1**2)
    return 3 + z2 - np.sqrt((3 - z1) * (3 + z1 + 2 * z2))


class Rays:
    """The traced rays (n, ngeo) with the screen points they pass."""

    M = 1.0
    E = 1.0

    def __init__(self, traced, alpha, beta, spin, inc, r_o=1000.0):
        self.__dict__.update(traced)
        self.alpha, self.beta = np.asarray(alpha), np.asarray(beta)
        self.spin, self.inc, self.r_o = float(spin), float(inc), r_o

    x = property(lambda s: s.r * np.sin(s.theta) * np.cos(s.phi))
    y = property(lambda s: s.r * np.sin(s.theta) * np.sin(s.phi))
    z = property(lambda s: s.r * np.cos(s.theta))
    Sigma = property(lambda s: kerr.sigma(s.r, s.theta, s.spin))
    Delta = property(lambda s: kerr.delta(s.r, s.spin))
    R = property(lambda s: kerr.r_potential(s.r, s.spin, s.lam[:, None],
                                            s.eta[:, None]))
    Theta = property(lambda s: kerr.theta_potential(
        s.theta, s.spin, s.lam[:, None], s.eta[:, None]))

    def keplerian_omega(self, direction=1.0, frac=1.0):
        return direction * frac / (self.r ** 1.5 + self.spin)


def metric_components(r, theta, spin, M=1.0):
    """Boyer-Lindquist metric g_munu non-zero components
    (reference kgeo.py:118-143)."""
    Sigma = r**2 + spin**2 * np.cos(theta) ** 2
    Delta = r**2 - 2 * M * r + spin**2
    Xi = (r**2 + spin**2) ** 2 - spin**2 * Delta * np.sin(theta) ** 2
    return {
        'tt': -(1 - 2 * M * r / Sigma),
        'rr': Sigma / Delta,
        'thth': Sigma,
        'phph': Xi * np.sin(theta) ** 2 / Sigma,
        'tph': -2 * M * spin * r * np.sin(theta) ** 2 / Sigma,
    }


def inv_metric_components(r, theta, spin, M=1.0):
    """Inverse metric g^munu non-zero components (reference kgeo.py:145-171)."""
    Sigma = r**2 + spin**2 * np.cos(theta) ** 2
    Delta = r**2 - 2 * M * r + spin**2
    return {
        'tt': -((r**2 + spin**2) ** 2
                - spin**2 * Delta * np.sin(theta) ** 2) / (Delta * Sigma),
        'rr': Delta / Sigma,
        'thth': 1 / Sigma,
        'phph': (Delta - spin**2 * np.sin(theta) ** 2)
                / (Delta * Sigma * np.sin(theta) ** 2),
        'tph': -2 * M * spin * r / (Delta * Sigma),
    }


def raise_or_lower_indices(g, u):
    """Contract a 4-vector with (inverse) metric components
    (reference kgeo.py:173-197). u shape (..., 4)."""
    return np.stack([
        g['tt'] * u[..., 0] + g['tph'] * u[..., 3],
        g['rr'] * u[..., 1],
        g['thth'] * u[..., 2],
        g['phph'] * u[..., 3] + g['tph'] * u[..., 0],
    ], axis=-1)


def wave_vector(geos):
    """Covariant photon momentum k_mu along rays (reference kgeo.py:91-116),
    with the integrator's exact momentum signs. Returns (..., 4)."""
    E = geos.E
    R = np.clip(geos.R, 0.0, None)
    Th = np.clip(geos.Theta, 0.0, None)
    Delta = geos.Delta
    k_t = np.broadcast_to(np.asarray(-E, Delta.dtype), Delta.shape)
    k_r = E * np.sqrt(R) * geos.pm_r / Delta
    k_th = E * np.sqrt(Th) * geos.pm_th
    k_ph = E * np.broadcast_to(geos.lam[..., None], Delta.shape)
    return np.stack([k_t, k_r, k_th, k_ph], axis=-1)


def azimuthal_velocity_vector(geos, Omega):
    """Contravariant u^mu for circular azimuthal flow with angular
    velocity Omega (reference kgeo.py:199-223). Returns (..., 4); ut is
    NaN outside the allowed circular-orbit region, which
    doppler_factor fills."""
    g = metric_components(geos.r, geos.theta, geos.spin, geos.M)
    Omega = np.asarray(Omega)
    denom = -(g['tt'] + 2 * Omega * g['tph'] + g['phph'] * Omega**2)
    with np.errstate(invalid='ignore', divide='ignore'):
        ut = 1.0 / np.sqrt(denom)
    zeros = np.zeros_like(ut)
    return np.stack([ut, zeros, zeros, ut * Omega], axis=-1)


def doppler_factor(geos, umu, fillna=0.0):
    """Doppler boost g = E / (-k.u) (reference kgeo.py:225-248)."""
    kdotu = np.sum(wave_vector(geos) * umu, axis=-1)
    with np.errstate(invalid='ignore', divide='ignore'):
        g = geos.E / -kdotu
    if fillna is not None and fillna is not False:
        g = np.nan_to_num(g, nan=fillna, posinf=fillna, neginf=fillna)
    return g


def fluid_frame_tetrad(geos, umu):
    """Orthonormal tetrad comoving with u^mu (reference kgeo.py:320-356).

    Returns (..., 4, 4) with [mu, a] layout: column a holds the coordinate
    components (e_a)^mu of frame vector a in (t, r, th, ph) order.
    """
    g = metric_components(geos.r, geos.theta, geos.spin, geos.M)
    u_mu = raise_or_lower_indices(g, umu)
    uu = u_mu * umu  # componentwise, (..., 4)

    u0u0, u1u1, u2u2, u3u3 = (uu[..., i] for i in range(4))
    with np.errstate(invalid='ignore', divide='ignore'):
        N_r = np.sqrt(-g['rr'] * (u0u0 + u3u3) * (1 + u2u2))
        N_th = np.sqrt(g['thth'] * (1 + u2u2))
        N_ph = np.sqrt(-(u0u0 + u3u3) * geos.Delta
                       * np.sin(geos.theta) ** 2)

        zeros = np.zeros_like(u0u0)
        e_t = -umu
        e_r = np.stack([u_mu[..., 1] * umu[..., 0], -(u0u0 + u3u3), zeros,
                        u_mu[..., 1] * umu[..., 3]],
                       axis=-1) / N_r[..., None]
        e_th = np.stack([u_mu[..., 2] * umu[..., 0],
                         u_mu[..., 2] * umu[..., 1], 1 + u2u2,
                         u_mu[..., 2] * umu[..., 3]],
                        axis=-1) / N_th[..., None]
        e_ph = np.stack([u_mu[..., 3], zeros, zeros, -u_mu[..., 0]],
                        axis=-1) / N_ph[..., None]
    return np.stack([e_t, e_r, e_th, e_ph], axis=-1)


def transform_coordinates(v, tetrad, contraction):
    """Frame <-> coordinate transformation (reference kgeo.py:65-89).

    tetrad layout (..., mu, a). 'upper': v'_a = sum_mu (e_a)^mu v_mu
    (coordinate covector -> frame components). 'lower': v^mu = sum_a
    v_a (e_a)^mu (frame components -> coordinate vector).
    """
    if contraction == 'upper':
        return np.einsum('...ma,...m->...a', tetrad, v)
    if contraction == 'lower':
        return np.einsum('...ma,...a->...m', tetrad, v)
    raise ValueError("contraction must be 'upper' or 'lower'")


def magnetic_field_fluid_frame(geos, umu, arad, avert, ator):
    """Lab-frame constant-geometry B-field boosted to the fluid frame
    (reference kgeo.py:274-318). Returns spatial frame components (..., 3)."""
    theta = geos.theta
    Br = arad * np.sin(theta) + avert * np.cos(theta)
    Bth = avert * (-np.sin(theta))
    Bph = ator * np.ones_like(theta)

    g = metric_components(geos.r, theta, geos.spin, geos.M)
    u_mu = raise_or_lower_indices(g, umu)
    e_mu = fluid_frame_tetrad(geos, umu)

    with np.errstate(invalid='ignore', divide='ignore'):
        b0 = Br * u_mu[..., 1] + Bth * u_mu[..., 2] + Bph * u_mu[..., 3]
        b1 = (Br + b0 * u_mu[..., 1]) / u_mu[..., 0]
        b2 = (Bth + b0 * u_mu[..., 2]) / u_mu[..., 0]
        b3 = (Bph + b0 * u_mu[..., 3]) / u_mu[..., 0]
        b_mu = np.stack([
            g['tt'] * b0 + g['tph'] * b3,
            g['rr'] * b1,
            g['thth'] * b2,
            g['phph'] * b3 + g['tph'] * b0,
        ], axis=-1)
        return transform_coordinates(b_mu, e_mu, 'upper')[..., 1:]


def _parallel_transport_core(geos, e_mu, g, b, Q_frac, V_frac, spectral_index):
    """Shared core of the fluid-frame / ZAMO parallel transport paths
    (reference kgeo.py:438-519 and kgeo.py:521-593)."""
    theta, r, spin = geos.theta, geos.r, geos.spin
    k_mu = wave_vector(geos)
    with np.errstate(invalid='ignore', divide='ignore'):
        k_prime = transform_coordinates(k_mu, e_mu, 'upper')[..., 1:]
        k_mag = np.sqrt(np.sum(k_prime**2, axis=-1))
        f_local = np.cross(k_prime, b, axis=-1) / k_mag[..., None]

        # local EVPA vector back to global (contravariant) coordinates
        f_padded = np.concatenate(
            [np.zeros_like(f_local[..., :1]), f_local], axis=-1)
        f_global = transform_coordinates(f_padded, e_mu, 'lower')
        ft, fr, fth, fph = (f_global[..., i] for i in range(4))

        # synchrotron emissivity scalings (power-law, spectral index alpha)
        b_mag = np.sqrt(np.sum(b**2, axis=-1))
        sin_th_b = np.sqrt(np.sum(f_local**2, axis=-1)) / k_mag
        I = (g**spectral_index * b_mag ** (spectral_index + 1)
             * sin_th_b ** (spectral_index + 1))
        Q = Q_frac * I
        U = np.zeros_like(Q)

        # Penrose-Walker constant kappa -> screen rotation chi2
        # (Himwich2020), in real arithmetic as the reference has it:
        # kappa = (r - i a cos(th)) (A - i B); the angle of
        # ((beta + i mu) conj(kappa)) / ((beta - i mu) kappa) is
        # 2 angle(z) for z = (beta + i mu) conj(kappa), and only cos/sin
        # of chi2 enter the Stokes rotation.
        gmunu = inv_metric_components(r, theta, spin, geos.M)
        kmu = raise_or_lower_indices(gmunu, k_mu)
        sin_t = np.sin(theta)
        A = ((kmu[..., 0] * fr - kmu[..., 1] * ft)
             + spin * sin_t**2 * (kmu[..., 1] * fph - kmu[..., 3] * fr))
        B = (((r**2 + spin**2) * (kmu[..., 3] * fth - kmu[..., 2] * fph)
              - spin * (kmu[..., 0] * fth - kmu[..., 2] * ft)) * sin_t)
        ac = spin * np.cos(theta)
        kappa_re = r * A - ac * B
        kappa_im = -(r * B + ac * A)
        alpha_px = geos.alpha[..., None]
        beta_px = geos.beta[..., None]
        mu_s = -(alpha_px + spin * np.sin(geos.inc))
        z_re = beta_px * kappa_re + mu_s * kappa_im
        z_im = mu_s * kappa_re - beta_px * kappa_im
        chi2 = 2.0 * np.arctan2(z_im, z_re)

        J_q = np.cos(chi2) * Q - np.sin(chi2) * U
        J_u = np.sin(chi2) * Q + np.cos(chi2) * U

        if V_frac:
            cot_th_b = np.sqrt(np.clip(1 - sin_th_b**2, 0.0, None)) / sin_th_b
            V = (V_frac * g ** (-spectral_index - 0.5)
                 * b_mag ** (spectral_index + 1.5)
                 * sin_th_b ** (spectral_index + 1.5) * cot_th_b)
            return np.stack([I, J_q, J_u, V], axis=0)
    return np.stack([I, J_q, J_u], axis=0)


def parallel_transport(geos, umu, g, b, Q_frac=0.2, V_frac=0.01,
                       spectral_index=1):
    """Stokes transport factors J = (I, Q, U[, V]) for fluid-frame emission
    (reference kgeo.py:438-519). b: fluid-frame spatial B, (..., 3)."""
    if not 0.0 <= Q_frac <= 1.0:
        raise ValueError('Q_frac should be in [0, 1]')
    e_mu = fluid_frame_tetrad(geos, umu)
    return _parallel_transport_core(geos, e_mu, g, b, Q_frac, V_frac,
                                    spectral_index)


def rotate_evpa(stokes, angle):
    """e^{2i angle}(Q + iU) of an (I, Q, U, ...) stack along axis 0."""
    c, s = np.cos(2 * angle), np.sin(2 * angle)
    q, u = stokes[1], stokes[2]
    return np.stack([stokes[0], c * q - s * u, s * q + c * u, *stokes[3:]])


def alma_physics(rays, model, rot_angle):
    """(Omega, J (3, n, ngeo)) of the ALMA model block over `rays`
    (`alma._model_physics`): Keplerian flow, the fluid-frame B field
    normalised over the supervised domain, the Stokes transport, the EVPA
    rotation. The B normalisation needs every sample of the screen, so
    `rays` is the whole table of one variant."""
    rot_sign = {'cw': -1, 'ccw': 1}
    z_width = model['z_width']
    rmin = (float(isco_pro(rays.spin)) if model['rmin'] == 'ISCO'
            else model['rmin'])
    rmax = model['fov_M'] / 2
    Omega = rays.keplerian_omega(direction=rot_sign[model['Omega_dir']],
                                 frac=model.get('Omega_frac', 1.0))
    umu = azimuthal_velocity_vector(rays, Omega)
    g = doppler_factor(rays, umu)
    b = magnetic_field_fluid_frame(rays, umu, **model['b_consts'])
    domain = (np.abs(rays.z) < z_width) & (rays.r > rmin) & (rays.r < rmax)
    b = b / np.nanmean(np.sqrt(np.sum(b[domain] ** 2, axis=-1)))
    J = np.nan_to_num(parallel_transport(rays, umu, g, b,
                                         Q_frac=model['Q_frac'], V_frac=0),
                      nan=0.0)
    return Omega, rotate_evpa(J, rot_angle), g
