"""The velocity warp and the supervision-domain mask.

PyTorch counterpart of the main-path subset of `bhnerf_tpu/emission.py`
(:101-222): the rigid-rotation velocity warp that maps every frame back
to the canonical t0 frame, and the emission-shell mask. The synthetic
emission generators and the full forward movie renderer are not ported
yet.
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
