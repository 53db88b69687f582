"""General-relativistic operators needed to freeze the ray constants.

PyTorch-package counterpart of the main-path subset of
`bhnerf_tpu/ops/gr.py` (:27-107, :313): metric, photon wave vector,
azimuthal fluid velocity and Doppler factor run once per configuration
on the host in numpy float64; `radiative_transfer` is the dense ray
integral in torch. Vectors carry a trailing mu axis (..., 4).
"""
from __future__ import annotations

import numpy as np
import torch

from bhnerf_tpu_torch import utils


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


def radiative_transfer(emission, g, dtau, Sigma):
    """Ray integral: pixel = sum_geo g^2 * emission * dtau * Sigma
    (reference kgeo.py:595-622)."""
    ndim = emission.ndim
    g = utils.expand_dims(g, ndim)
    dtau = utils.expand_dims(dtau, ndim)
    Sigma = utils.expand_dims(Sigma, ndim)
    return torch.sum(g**2 * emission * dtau * Sigma, dim=-1)
