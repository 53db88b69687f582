"""The velocity warp, the supervision-domain mask and Stokes helpers.

PyTorch counterpart of a subset of `bhnerf_tpu/emission.py`: the
rigid-rotation velocity warp that maps every frame back to the canonical
t0 frame and the emission-shell mask (:101-222), the per-sample Stokes
factors of the dense render (:228), and the host-side Stokes helpers
`normalize_stokes` and `rotate_evpa` (:360-397), which work on numpy
arrays like the rest of the once-per-configuration precompute. The
synthetic emission generators and the full forward movie renderer are
not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from bhnerf_tpu_torch import constants as consts
from bhnerf_tpu_torch import units, utils


def velocity_warp_matrix(coords_ndim, Omega, t_frames, t_start_obs, t_geos,
                         t_injection, rot_axis=(0, 0, 1),
                         M=consts.sgra_mass, t_units=None):
    """Rotation angles + validity mask for the velocity warp.

    Returns (theta_rot, valid): theta_rot is the rigid-rotation angle that
    maps frame-time samples back to the canonical t0 frame, valid marks
    samples after the injection time. NaN-free by construction.
    """
    Omega = torch.as_tensor(Omega)

    if isinstance(t_start_obs, units.Quantity):
        t_units = t_start_obs.unit
        t_start_obs = t_start_obs.value
    elif t_units is None and isinstance(t_frames, units.Quantity):
        t_units = t_frames.unit

    GM_c3 = 1.0
    if t_units is not None:
        GM_c3 = consts.GM_c3(M).to(t_units).value

    if isinstance(t_frames, units.Quantity):
        t_frames = (t_frames.to(t_units).value if t_units is not None
                    else t_frames.value)
    t_frames = torch.as_tensor(t_frames, device=Omega.device)

    if Omega.ndim == 0:
        Omega = Omega[None]
        while Omega.ndim < coords_ndim - 1:
            Omega = Omega[..., None]

    # broadcast frame times against ray-sample dims
    if t_frames.ndim != 0:
        t_frames = utils.expand_dims(t_frames, t_frames.ndim + Omega.ndim, -1)

    t_geos = (t_frames - t_start_obs) / GM_c3 + torch.as_tensor(
        t_geos, device=Omega.device)
    t_M = t_geos - t_injection
    valid = t_M >= 0.0
    theta_rot = torch.where(valid, t_M, torch.zeros_like(t_M)) * Omega
    return theta_rot, valid


def velocity_warp_coords(coords, Omega, t_frames, t_start_obs, t_geos,
                         t_injection, rot_axis=(0, 0, 1),
                         M=consts.sgra_mass, t_units=None):
    """Warp sampling coordinates back to the canonical frame
    (reference emission.py:143-211).

    coords: stacked [x, y, z] with axis 0 the component axis. Returns
    (warped (..., 3), valid) with zeros, not NaN, in invalid slots.
    """
    coords = torch.as_tensor(coords)
    theta_rot, valid = velocity_warp_matrix(
        coords.ndim, Omega, t_frames, t_start_obs, t_geos, t_injection,
        rot_axis, M, t_units)

    inv_rot = utils.rotation_matrix(rot_axis, -theta_rot)
    # inv_rot: (3, 3, *batch); coords: (3, *spatial). Contract axis 1 of
    # the matrix against the component axis of coords with broadcasting
    if theta_rot.ndim >= coords.ndim:  # frame axis prepended
        coords = utils.expand_dims(coords, theta_rot.ndim + 1, 1)
    warped = torch.sum(inv_rot * coords[None], dim=1)
    return torch.movedim(warped, 0, -1), valid


def domain_mask(coords, rmin=0.0, rmax=np.inf, z_width=np.inf):
    """Boolean mask of the supervised emission shell: rmin <= r <= rmax
    and |z| <= z_width. The single domain predicate shared by the dense,
    fused and compacted pipelines. coords: (3, ...) tensor or array."""
    coords = torch.as_tensor(coords)
    r_sq = torch.sum(coords * coords, dim=0)
    mask = torch.ones_like(r_sq, dtype=torch.bool)
    if rmin > 0:
        mask &= r_sq >= rmin**2
    if np.isfinite(rmax):
        mask &= r_sq <= rmax**2
    if np.isfinite(z_width):
        mask &= torch.abs(coords[2]) <= z_width
    return mask


def fill_unsupervised_emission(emission, coords, rmin=0.0, rmax=np.inf,
                               z_width=2.0, fill_value=0.0):
    """Zero emission outside the supervised shell
    (reference emission.py:343-374). coords: stacked [x, y, z], axis 0."""
    keep = domain_mask(coords, rmin, rmax, z_width)
    return torch.where(keep, emission, torch.full_like(emission, fill_value))


def apply_stokes_factors(emission, J):
    """Multiply per-sample Stokes factors J ((nstokes, ...sample dims))
    onto emission ((*frame_dims, ...sample dims)), inserting the Stokes
    axis after the frame dims (reference emission.py:228-240). A scalar
    or 0-d J is a plain intensity scale."""
    if isinstance(J, torch.Tensor) and J.ndim > 0:
        nt_dims = emission.ndim - 3
        return J.reshape((1,) * nt_dims + tuple(J.shape)) \
            * emission.unsqueeze(nt_dims)
    if float(J) == 1.0:
        return emission
    return emission * float(J)


def normalize_stokes(movie, I_flux, P_flux, V_flux=None):
    """Normalize a Stokes movie to target fluxes (reference
    emission.py:360-373). movie: numpy array (nt, nstokes, ny, nx)."""
    movie = np.asarray(movie)
    dolp = np.sqrt(np.sum(movie[:, 1:3].sum(axis=(-1, -2)) ** 2,
                          axis=1)).mean()
    parts = [movie[:, 0:1] * (I_flux / movie[:, 0].sum(axis=(-1, -2)).mean()),
             movie[:, 1:3] * (P_flux / dolp)]
    if V_flux is not None and movie.shape[1] > 3:
        parts.append(movie[:, 3:4]
                     * (V_flux / movie[:, 3].sum(axis=(-1, -2)).mean()))
    elif movie.shape[1] > 3:
        parts.append(movie[:, 3:])
    return np.concatenate(parts, axis=1)


def rotate_evpa(stokes, angle, axis=0):
    """Rotate the EVPA of a Stokes vector by `angle` (reference
    emission.py:376-397): e^{2i angle}(Q + iU) in real arithmetic.
    stokes: numpy array whose `axis` holds (Q, U), (I, Q, U) or
    (I, Q, U, V)."""
    stokes = np.asarray(stokes)
    n = stokes.shape[axis]
    c, s = np.cos(2 * angle), np.sin(2 * angle)
    take = lambda i: np.take(stokes, i, axis)
    if n not in (2, 3, 4):
        raise ValueError(f'stokes axis size {n} not supported')
    q, u = (take(0), take(1)) if n == 2 else (take(1), take(2))
    parts = [c * q - s * u, s * q + c * u]
    if n >= 3:
        parts.insert(0, take(0))
    if n == 4:
        parts.append(take(3))
    return np.stack(parts, axis=axis)
