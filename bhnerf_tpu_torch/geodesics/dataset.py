"""Geodesics container + image-plane tracing (host float64).

PyTorch counterpart of `bhnerf_tpu/geodesics/dataset.py`. Geodesic tables
are a once-per-configuration host precompute in float64, as in the
reference; the training that consumes them runs on the GPU. The container
keeps host numpy float64 leaves and writes the same npz format as the
reference (`save`/`load`), so tables cross between the two packages.

Array layout matches the reference: (num_alpha, num_beta, ngeo).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bhnerf_tpu_torch.geodesics import integrator


@dataclasses.dataclass(frozen=True)
class Geodesics:
    """Bundle of ray samples + conserved quantities for one image plane."""

    # per-sample arrays, shape (num_alpha, num_beta, ngeo)
    r: np.ndarray
    theta: np.ndarray
    phi: np.ndarray
    t: np.ndarray
    mino: np.ndarray
    dtau: np.ndarray
    pm_r: np.ndarray          # sign of (forward) radial momentum
    pm_th: np.ndarray         # sign of (forward) polar momentum
    # per-pixel arrays, shape (num_alpha, num_beta)
    alpha: np.ndarray
    beta: np.ndarray
    lam: np.ndarray
    eta: np.ndarray
    tau_final: np.ndarray
    # scalars
    spin: float
    inc: float
    M: float = 1.0
    E: float = 1.0
    r_o: float = 1000.0

    _FIELDS = ('r', 'theta', 'phi', 't', 'mino', 'dtau', 'pm_r', 'pm_th',
               'alpha', 'beta', 'lam', 'eta', 'tau_final')
    _AUX = ('spin', 'inc', 'M', 'E', 'r_o')

    # cartesian coordinates (reference emission.py:271)
    @property
    def x(self):
        return self.r * np.sin(self.theta) * np.cos(self.phi)

    @property
    def y(self):
        return self.r * np.sin(self.theta) * np.sin(self.phi)

    @property
    def z(self):
        return self.r * np.cos(self.theta)

    # metric functions and potentials, numpy float64
    @property
    def Sigma(self):
        return self.r**2 + self.spin**2 * np.cos(self.theta) ** 2

    @property
    def Delta(self):
        return self.r**2 - 2.0 * self.r + self.spin**2

    @property
    def R(self):
        lam = self.lam[..., None]
        eta = self.eta[..., None]
        return ((self.r**2 + self.spin**2 - self.spin * lam) ** 2
                - self.Delta * (eta + (lam - self.spin) ** 2))

    @property
    def Theta(self):
        lam = self.lam[..., None]
        eta = self.eta[..., None]
        cos2 = np.cos(self.theta) ** 2
        sin2 = np.sin(self.theta) ** 2
        return eta + self.spin**2 * cos2 - lam**2 * cos2 / sin2

    def save(self, path):
        """Serialize to .npz (the reference's format, dataset.py:151-156)."""
        arrays = {f: np.asarray(getattr(self, f)) for f in self._FIELDS}
        np.savez_compressed(path, **arrays,
                            _aux=np.array([getattr(self, f)
                                           for f in self._AUX]))

    @classmethod
    def load(cls, path):
        blob = np.load(path)
        aux = blob['_aux']
        return cls(*(blob[f] for f in cls._FIELDS),
                   **dict(zip(cls._AUX, (float(a) for a in aux))))

    def keplerian_omega(self, direction=1.0, frac=1.0):
        """Keplerian angular velocity field along the rays
        (reference alma.py:49)."""
        return (direction * frac * np.sqrt(self.M)
                / (self.r ** 1.5 + self.spin * np.sqrt(self.M)))


def image_plane_geos(spin, inclination, alpha_range, beta_range, ngeo=100,
                     num_alpha=64, num_beta=64, distance=1000.0, E=1.0, M=1.0,
                     tau_max=4.0, n_fine=8192, substeps=8) -> Geodesics:
    """Trace Kerr geodesics for a regular image-plane grid
    (reference bhnerf/kgeo.py:6-63), host float64."""
    alpha_1d = np.linspace(*alpha_range, num_alpha)
    beta_1d = np.linspace(*beta_range, num_beta)
    alpha, beta = np.meshgrid(alpha_1d, beta_1d, indexing='ij')
    return trace_geodesics(alpha, beta, spin, inclination, ngeo=ngeo,
                           distance=distance, E=E, M=M, tau_max=tau_max,
                           n_fine=n_fine, substeps=substeps)


def trace_geodesics(alpha, beta, spin, inclination, ngeo=100, distance=1000.0,
                    E=1.0, M=1.0, tau_max=4.0, n_fine=8192,
                    substeps=8) -> Geodesics:
    """Trace geodesics for arbitrary (alpha, beta) screen points on the
    host CPU in float64. alpha/beta may be any (matching) shape; output
    arrays get a trailing ngeo axis."""
    if not 0.0 <= spin < 1.0:
        raise ValueError(f'spin must be in [0, 1), got {spin}')
    if not (E == 1.0 and M == 1.0):
        # rays are integrated in G = c = M = E = 1 units; physical mass
        # scaling enters through constants.GM_c3 time units
        raise ValueError(
            f'geodesics are traced in M=E=1 units (got M={M}, E={E}); '
            f'scale times/lengths via constants.GM_c3 / GM_c2')

    # exactly polar observers hit the phi coordinate singularity; nudge
    # off the axis (physically indistinguishable at 1e-6 rad)
    inclination = float(np.clip(inclination, 1e-6, np.pi - 1e-6))
    shape = np.shape(alpha)
    alpha_flat = np.ravel(np.asarray(alpha, np.float64))
    beta_flat = np.ravel(np.asarray(beta, np.float64))

    state0, lam, eta = integrator.initial_state(
        alpha_flat, beta_flat, spin, inclination, distance, torch.float64)
    tau_final = integrator.terminal_mino_time(
        state0, spin, lam, eta, distance, tau_max=tau_max, n_fine=n_fine)
    samples = integrator.sample_rays(
        state0, tau_final, spin, lam, eta, r_o=distance, ngeo=ngeo,
        substeps=substeps)
    samples = {k: v.numpy() for k, v in samples.items()}
    tau_final, lam, eta = tau_final.numpy(), lam.numpy(), eta.numpy()

    def per_sample(arr):
        # (ngeo, npix) -> (*shape, ngeo)
        return np.moveaxis(arr, 0, -1).reshape(*shape, ngeo)

    r = per_sample(1.0 / samples['u'])
    theta = per_sample(np.arccos(np.clip(samples['c'], -1.0, 1.0)))
    phi = per_sample(samples['phi'])
    # fold the integrator's running Kahan error back in
    t = per_sample(samples['t'] - samples['t_c'])
    pm_r = per_sample(samples['pm_r'])
    pm_th = per_sample(samples['pm_th'])

    tau_final = tau_final.reshape(shape)
    h = tau_final / (ngeo - 1)
    mino = h[..., None] * np.arange(ngeo)
    dtau = np.broadcast_to(h[..., None], mino.shape).copy()

    return Geodesics(
        r=r, theta=theta, phi=phi, t=t, mino=mino, dtau=dtau,
        pm_r=pm_r, pm_th=pm_th,
        alpha=alpha_flat.reshape(shape), beta=beta_flat.reshape(shape),
        lam=lam.reshape(shape), eta=eta.reshape(shape),
        tau_final=tau_final,
        spin=float(spin), inc=float(inclination), M=float(M), E=float(E),
        r_o=float(distance))
