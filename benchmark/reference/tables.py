"""The reference's ray constants for a sample of pixels: their rays traced
in float64 (`geodesics.trace`) and the configuration's physics
(`physics`), in the layout of the port's RayTracingArgs (per pixel, per
sample along the ray). Imports nothing of the program."""
from __future__ import annotations

import numpy as np

from benchmark.reference import geodesics, physics


def ray_constants(cfg, alpha_axis, beta_axis, pixels):
    """(coords (3, P, ngeo), Omega, J (nstokes, P, ngeo), g, dtau, Sigma,
    t_geos_rel) as a dict of float64 arrays for the flat pixel numbers
    `pixels` of the screen (alpha_axis x beta_axis, 'ij' order).

    The ALMA physics normalises the B field by its mean over the
    supervised domain of the whole screen, so for it every ray of the
    screen is traced and the pixels are taken afterwards."""
    a_axis, b_axis = np.asarray(alpha_axis), np.asarray(beta_axis)
    whole = cfg['physics'] == 'alma'
    traced_px = np.arange(len(a_axis) * len(b_axis)) if whole else pixels
    alpha = a_axis[traced_px // len(b_axis)]
    beta = b_axis[traced_px % len(b_axis)]
    inc = np.deg2rad(cfg['inclination_deg'])
    traced = geodesics.trace(alpha, beta, cfg['spin'], inc, ngeo=cfg['ngeo'],
                             n_fine=cfg['n_fine'])
    rays = physics.Rays(traced, alpha, beta, cfg['spin'], inc)
    if whole:
        omega, J, g = physics.alma_physics(
            rays, cfg, np.deg2rad(cfg['rot_angle_deg']))
    else:
        omega = rays.keplerian_omega()
        g = physics.doppler_factor(
            rays, physics.azimuthal_velocity_vector(rays, omega))
        J = np.ones((1,) + g.shape)
    t_injection = -(rays.r_o + cfg['fov_M'] / 4)
    out = {'coords': np.stack([rays.x, rays.y, rays.z]), 'Omega': omega,
           'J': J, 'g': g, 'dtau': rays.dtau, 'Sigma': rays.Sigma,
           't_geos_rel': rays.t - t_injection}
    return {k: v[..., pixels, :] for k, v in out.items()} if whole else out


def probe_image(consts, keep, t_M, rmax):
    """The image of a fixed smooth field over the samples `keep` of each
    pixel: sum over the ray of e(warped x) * J * g^2 * dtau * Sigma, with
    e a Gaussian blob off the axis, warped at frame time t_M (M).
    Returns (nstokes, P) float64: what the constants make of a field, as
    a fit uses them."""
    c = {k: np.asarray(v, np.float64) for k, v in consts.items()}
    tm = t_M + c['t_geos_rel']
    theta = np.where(tm >= 0.0, tm, 0.0) * c['Omega']
    x, y, z = c['coords']
    wx = np.cos(theta) * x + np.sin(theta) * y
    wy = np.cos(theta) * y - np.sin(theta) * x
    centre, width = (0.5 * rmax, 0.2 * rmax, 0.0), 0.35 * rmax
    e = np.exp(-((wx - centre[0]) ** 2 + (wy - centre[1]) ** 2
                 + (z - centre[2]) ** 2) / (2 * width**2)) * (tm >= 0.0)
    w = c['g'] ** 2 * c['dtau'] * c['Sigma'] * e * keep
    J = c['J'] if c['J'].ndim == 3 else np.ones((1,) + w.shape)
    return np.sum(J * w[None], axis=-1)
