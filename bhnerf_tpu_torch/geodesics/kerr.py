"""Kerr null-geodesic potentials and rates, in torch.

PyTorch counterpart of `bhnerf_tpu/geodesics/kerr.py`. Conventions
(G = c = M = 1, photon energy E = 1, Boyer-Lindquist coordinates, spin
0 <= a < 1, screen coordinates alpha = -lambda / sin(theta_o),
beta = p_theta at the observer) and the trig-free (u = 1/r, c = cos theta)
forms of the radial and polar potentials are those of the reference
module docstring. Every function is elementwise and works on tensors of
any float dtype; the host tracer runs them in float64. The conserved
quantities, the metric functions (Delta, Sigma, Xi, omega), the
potentials R and Theta and the Keplerian angular velocity also take
numpy arrays, in numpy, so that the numpy tables of `dataset.Geodesics`
compute them with the same formulas.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _xp(x):
    """torch for a tensor, numpy for anything else."""
    return torch if isinstance(x, torch.Tensor) else np


def horizon(spin):
    """Outer event horizon r_+ in M units."""
    return 1.0 + math.sqrt(1.0 - spin**2)


def conserved_quantities(alpha, beta, spin, inc):
    """Energy-rescaled angular momentum lambda and Carter constant eta of
    the rays through screen points (alpha, beta) [M] of an observer at
    inclination `inc` [rad, a scalar]."""
    lam = -alpha * np.sin(inc)
    eta = (alpha**2 - spin**2) * np.cos(inc) ** 2 + beta**2
    return lam, eta


def Delta(r, spin):
    return r**2 - 2.0 * r + spin**2


def Sigma(r, theta, spin):
    return r**2 + spin**2 * _xp(theta).cos(theta) ** 2


def Xi(r, theta, spin):
    """Metric function  Xi = (r^2+a^2)^2 - a^2 Delta sin^2(theta)."""
    return ((r**2 + spin**2) ** 2
            - spin**2 * Delta(r, spin) * _xp(theta).sin(theta) ** 2)


def omega(r, theta, spin):
    """Frame-dragging angular velocity  omega = 2 a r / Xi."""
    return 2.0 * spin * r / Xi(r, theta, spin)


def R_potential(r, spin, lam, eta):
    return ((r**2 + spin**2 - spin * lam) ** 2
            - Delta(r, spin) * (eta + (lam - spin) ** 2))


def Theta_potential(theta, spin, lam, eta):
    xp = _xp(theta)
    cos2 = xp.cos(theta) ** 2
    sin2 = xp.sin(theta) ** 2
    return eta + spin**2 * cos2 - lam**2 * cos2 / sin2


def U_potential(u, spin, lam, eta):
    """u^4 R(1/u): quartic radial potential in inverse radius u = 1/r."""
    c2 = spin**2 - spin * lam
    k = eta + (lam - spin) ** 2
    a_ = 1.0 + c2 * u**2
    return a_**2 - (1.0 - 2.0 * u + spin**2 * u**2) * u**2 * k


def dU_du(u, spin, lam, eta):
    """d/du of U_potential (drives the smooth 2nd-order radial ODE)."""
    c2 = spin**2 - spin * lam
    k = eta + (lam - spin) ** 2
    a_ = 1.0 + c2 * u**2
    return 4.0 * c2 * u * a_ - k * (2.0 * u - 6.0 * u**2 + 4.0 * spin**2 * u**3)


# polar dynamics in c = cos(theta): (dc/dtau)^2 = C(c), the Gralla-Lupsasca
# angular quartic, so the integrator's right-hand side is polynomial
def C_potential(c, spin, lam, eta):
    return eta + (spin**2 - eta - lam**2) * c**2 - spin**2 * c**4


def dC_dc(c, spin, lam, eta):
    return 2.0 * (spin**2 - eta - lam**2) * c - 4.0 * spin**2 * c**3


def phi_rate(u, c, spin, lam):
    """d(phi)/dtau for the forward (emission -> observer) photon, in
    (u, c); the lam/sin^2(theta) term is guarded for polar rays."""
    r = 1.0 / u
    delta = Delta(r, spin)
    sin2 = torch.clamp(1.0 - c**2, min=1e-12)
    return (spin / delta * (r**2 + spin**2 - spin * lam)
            + lam / sin2 - spin)


def t_rate(u, c, spin, lam):
    """d(t)/dtau for the forward photon, in (u, c) variables."""
    r = 1.0 / u
    delta = Delta(r, spin)
    return ((r**2 + spin**2) / delta * (r**2 + spin**2 - spin * lam)
            + spin * (lam - spin * (1.0 - c**2)))


def keplerian_omega(r, spin, M=1.0, direction=1.0, frac=1.0):
    """Keplerian angular velocity Omega = sqrt(M)/(r^{3/2} + a sqrt(M))
    (reference bhnerf/alma.py:49, Tutorial2)."""
    return direction * frac * np.sqrt(M) / (r ** 1.5 + spin * np.sqrt(M))
