"""Synthetic emission, the velocity warp, the forward movie renderer, the
supervision-domain mask and Stokes helpers.

PyTorch counterpart of `bhnerf_tpu/emission.py`: the synthetic
generators (the hotspot and the flux tube :35-81, the equatorial ring
:84-98, a flat-space advected field :325-337 and a Gaussian-random-field
disk seen through the geodesics :340-357), the rigid-rotation velocity
warp that maps every frame back to the canonical t0 frame and the
emission-shell mask (:101-222), trilinear sampling of a 3D field (:181),
the forward movie renderer `image_plane_dynamics` (:243-322) with the
per-sample Stokes factors (:228), and the host-side Stokes helpers
`normalize_stokes` and `rotate_evpa` (:360-397), which work on numpy
arrays like the rest of the once-per-configuration precompute.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from bhnerf_tpu_torch import constants as consts
from bhnerf_tpu_torch import units, utils
from bhnerf_tpu_torch.geodesics import equatorial
from bhnerf_tpu_torch.ops import gr

# image_plane_dynamics renders frames in chunks that keep its eager warp
# and interpolation temporaries within this many bytes of device memory.
# A chunk's peak grows by 146 bytes a sample and frame for a static field
# and a scalar J (chip_smoke.py's recovery phase, NVIDIA H100 80GB HBM3);
# per-sample Stokes factors add to that
RENDER_BUDGET_BYTES = 2 ** 31
_BYTES_PER_SAMPLE_FRAME = 160


def _orbit_rotation(rot_axis):
    """Rotation taking the z axis onto the orbit normal `rot_axis`
    (reference emission.py:24-32), in float32 as the reference builds
    it."""
    rot_axis = np.asarray(rot_axis, dtype=np.float64)
    rot_axis = rot_axis / np.sqrt(np.sum(rot_axis**2))
    z_axis = np.array([0.0, 0.0, 1.0])
    rot_axis_prime = np.cross(z_axis, rot_axis)
    if np.sqrt(np.sum(rot_axis_prime**2)) < 1e-5:
        rot_axis_prime = z_axis
    rot_angle_prime = np.arccos(np.dot(rot_axis, z_axis))
    return utils.rotation_matrix(
        rot_axis_prime, torch.tensor(rot_angle_prime,
                                     dtype=torch.float32)).numpy()


def generate_hotspot(resolution, rot_axis, rot_angle, orbit_radius, std,
                     r_isco, fov, std_clip=np.inf, normalize=True):
    """Gaussian hotspot on a circular orbit (reference emission.py:35-56):
    a Grid3D on the host, 2D or 3D by the length of `resolution`,
    normalised to a unit integral unless `normalize` is False."""
    if orbit_radius < r_isco:
        raise ValueError(
            f'hotspot center ({orbit_radius}) is within r_isco: {r_isco}')
    resolution = tuple(int(n) for n in np.atleast_1d(resolution))
    center_2d = orbit_radius * np.array([np.cos(rot_angle), np.sin(rot_angle)])
    if len(resolution) == 2:
        center = center_2d
    else:
        center = _orbit_rotation(rot_axis) @ np.append(center_2d, 0.0)
    emission = utils.gaussian_field(resolution, center, std, fov=fov,
                                    std_clip=std_clip)
    if normalize:
        emission = emission / emission.integrate()
    return emission


def generate_tube(resolution, rot_axis, phi_start, phi_end, orbit_radius, std,
                  r_isco, fov, std_clip=np.inf, normalize=True):
    """Azimuthal flux-tube arc with a Gaussian cross-section (reference
    emission.py:56-81): the sum of Gaussian blobs every 0.015 rad of
    azimuth over [phi_start, phi_end) on the orbit of `orbit_radius` in the
    plane normal to `rot_axis`; a Grid3D on the host, normalised to a unit
    integral unless `normalize` is False. An arc that wraps through 2 pi
    is given as phi_end = phi_start + extent."""
    if orbit_radius < r_isco:
        raise ValueError(
            f'tube radius ({orbit_radius}) is within r_isco: {r_isco}')
    resolution = tuple(int(n) for n in np.atleast_1d(resolution))
    if phi_end <= phi_start:
        raise ValueError(
            f'empty tube range [{phi_start}, {phi_end}): for an arc '
            f'wrapping through 2*pi pass phi_end = phi_start + extent '
            f'(angles beyond 2*pi wrap naturally)')
    rot_matrix = _orbit_rotation(rot_axis)
    data = 0.0
    for phi in np.arange(phi_start, phi_end, 0.015):
        center_2d = orbit_radius * np.array([np.cos(phi), np.sin(phi)])
        grid = utils.gaussian_field(resolution,
                                    rot_matrix @ np.append(center_2d, 0.0),
                                    std, fov=fov, std_clip=std_clip)
        data = data + grid.data
    emission = utils.Grid3D(data, grid.start, grid.stop)
    if normalize:
        emission = emission / emission.integrate()
    return emission


def equatorial_ring(geos, mbar):
    """Unit emission at the sample nearest the mbar-th equatorial crossing
    of each ray, zero elsewhere (reference emission.py:84-98): a numpy
    array shaped like geos.r. Crossings are detected by
    geodesics.equatorial.crossing_index."""
    found, _, idx_nearest = equatorial.crossing_index(geos, mbar)
    emission = np.zeros_like(geos.r)
    it = np.indices(idx_nearest.shape)
    emission[(*it, idx_nearest)] = np.where(found, 1.0, 0.0)
    return emission


def _as_tensor(x, device=None):
    """A tensor as it is; anything else as a float32 tensor, as the
    reference's jnp.asarray makes one."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _frame_times(t_frames, t_start_obs, M, t_units=None):
    """The velocity warp's units rule (reference emission.py:111-128):
    times are in t_start_obs's unit, else in `t_units`, else in
    t_frames's, else in M. Returns (t_frames, t_start_obs, GM_c3): the
    plain values in that unit and the length of one M in it (1.0 for
    times in M)."""
    if isinstance(t_start_obs, units.Quantity):
        t_units = t_start_obs.unit
        t_start_obs = t_start_obs.value
    elif t_units is None and isinstance(t_frames, units.Quantity):
        t_units = t_frames.unit
    if isinstance(t_frames, units.Quantity):
        t_frames = (t_frames.to(t_units).value if t_units is not None
                    else t_frames.value)
    GM_c3 = 1.0 if t_units is None else consts.GM_c3(M).to(t_units).value
    return t_frames, t_start_obs, GM_c3


def velocity_warp_matrix(coords_ndim, Omega, t_frames, t_start_obs, t_geos,
                         t_injection, rot_axis=(0, 0, 1),
                         M=consts.sgra_mass, t_units=None):
    """Rotation angles + validity mask for the velocity warp.

    Returns (theta_rot, valid): theta_rot is the rigid-rotation angle that
    maps frame-time samples back to the canonical t0 frame, valid marks
    samples after the injection time. NaN-free by construction.
    """
    Omega = _as_tensor(Omega)
    t_frames, t_start_obs, GM_c3 = _frame_times(t_frames, t_start_obs, M,
                                                t_units)
    t_frames = _as_tensor(t_frames, Omega.device)

    if Omega.ndim == 0:
        Omega = Omega[None]
        while Omega.ndim < coords_ndim - 1:
            Omega = Omega[..., None]

    # broadcast frame times against ray-sample dims
    if t_frames.ndim != 0:
        t_frames = utils.expand_dims(t_frames, t_frames.ndim + Omega.ndim, -1)

    t_geos = (t_frames - t_start_obs) / GM_c3 + _as_tensor(t_geos,
                                                           Omega.device)
    t_M = t_geos - t_injection
    valid = t_M >= 0.0
    theta_rot = torch.where(valid, t_M, torch.zeros_like(t_M)) * Omega
    return theta_rot, valid


def velocity_warp_coords(coords, Omega, t_frames, t_start_obs, t_geos,
                         t_injection, rot_axis=(0, 0, 1),
                         M=consts.sgra_mass, t_units=None,
                         fill_nan=True, return_mask=False):
    """Warp sampling coordinates back to the canonical frame
    (reference emission.py:143-211).

    coords: stacked [x, y, z] with axis 0 the component axis. Returns the
    warped coordinates (..., 3). With `return_mask=True` it returns
    (warped, valid) with the rotation of invalid slots (before injection)
    taken at t = t_injection, NaN-free; otherwise, with `fill_nan=True`
    (the default), invalid slots are NaN, the reference's behaviour.
    """
    coords = _as_tensor(coords)
    Omega = _as_tensor(Omega, coords.device)
    theta_rot, valid = velocity_warp_matrix(
        coords.ndim, Omega, t_frames, t_start_obs, t_geos, t_injection,
        rot_axis, M, t_units)

    inv_rot = utils.rotation_matrix(rot_axis, -theta_rot)
    # inv_rot: (3, 3, *batch); coords: (3, *spatial). Contract axis 1 of
    # the matrix against the component axis of coords with broadcasting
    if theta_rot.ndim >= coords.ndim:  # frame axis prepended
        coords = utils.expand_dims(coords, theta_rot.ndim + 1, 1)
    warped = torch.movedim(torch.sum(inv_rot * coords[None], dim=1), 0, -1)
    if return_mask:
        return warped, valid
    if fill_nan:
        warped = torch.where(valid[..., None], warped,
                             torch.full_like(warped, float('nan')))
    return warped


def interpolate_coords(emission, coords):
    """Trilinear sample of a 3D field at world coordinates (reference
    emission.py:181-195): jax.scipy.ndimage.map_coordinates(order=1,
    cval=0) written out as its 8-corner gather with floor weights, so an
    out-of-range corner contributes 0 and points near the border blend
    toward 0. emission: Grid3D; coords: (..., 3) tensor. Returns (...) on
    the device of `coords`."""
    if not isinstance(emission, utils.Grid3D):
        raise TypeError('interpolate_coords requires a Grid3D field')
    data = emission.data.to(coords.device)
    idx = utils.world_to_image_coords(coords, emission.fov, data.shape)
    return map_coordinates_linear(data, idx)


def map_coordinates_linear(data, idx):
    """jax.scipy.ndimage.map_coordinates(data, idx, order=1, cval=0.0) of a
    3D tensor at image coordinates idx (..., 3): the 8-corner gather with
    floor weights, an out-of-range corner contributing 0. Differentiable
    in `data` and `idx`."""
    shape = data.shape
    nodes = []
    for d, size in enumerate(shape):
        lower = torch.floor(idx[..., d])
        upper_weight = idx[..., d] - lower
        index = lower.to(torch.int64)
        nodes.append([(index, 1 - upper_weight), (index + 1, upper_weight)])
    flat = data.reshape(-1)
    out = None
    # the reference's order: corners in itertools.product order, each
    # weight the product of its three 1D weights
    for corner in itertools.product(*nodes):
        valid, offset, weight = True, 0, None
        for (index, w), size in zip(corner, shape):
            valid = valid & (index >= 0) & (index < size)
            offset = offset * size + index.clamp(0, size - 1)
            weight = w if weight is None else weight * w
        value = weight * torch.where(valid, flat[offset], 0.0)
        out = value if out is None else out + value
    return out


def image_plane_dynamics(emission_0, geos, Omega, t_frames, t_injection,
                         J=1.0, t_start_obs=None, slow_light=True,
                         doppler=True, rot_axis=(0, 0, 1),
                         M=consts.sgra_mass, frame_chunk=None,
                         device='cuda'):
    """Render the image-plane movie of a rigidly rotating 3D emission field
    (reference emission.py:243-322) on `device`.

    emission_0: Grid3D, or a movie Grid3D with a leading time axis of one
    frame per entry of t_frames. J: a scalar intensity scale or Stokes
    factors (nstokes, na, nb, ngeo). Returns (nt, [nstokes,] na, nb).

    The time arithmetic is done in float64 on the host and cast, as
    raytracing_args does: each frame's offset from t_start_obs in M and
    each sample's t_geos - t_injection, added in float32 on the device
    (the reference adds all of it in float32 with t_geos near -1000 M).
    Frames are rendered in chunks of `frame_chunk` (by default as many as
    RENDER_BUDGET_BYTES holds), with t_start_obs pinned to the first
    frame of the whole movie."""
    if not isinstance(emission_0, utils.Grid3D):
        raise TypeError('emission_0 must be a Grid3D')
    is_movie = emission_0.data.ndim != emission_0.spatial_ndim
    if t_start_obs is None:
        if isinstance(t_frames, units.Quantity):
            t_start_obs = t_frames[0] if t_frames.ndim else t_frames
        else:
            t_start_obs = np.atleast_1d(np.asarray(t_frames))[0]
    t_frames, t_start_obs, GM_c3 = _frame_times(t_frames, t_start_obs, M)
    t_M = ((np.asarray(t_frames, np.float64) - float(t_start_obs))
           / GM_c3)
    nt = t_M.shape[0] if t_M.ndim else 1
    if is_movie and emission_0.data.shape[0] != nt:
        raise ValueError(
            f'movie emission has {emission_0.data.shape[0]} frames but '
            f't_frames has {nt}: frame i is rendered at time i (interpolate '
            f'or resample one of them first)')

    as_t = lambda x: _as_tensor(x, device)
    t_geos = np.asarray(geos.t, np.float64) if slow_light else 0.0
    t_geos_rel = as_t(np.broadcast_to(t_geos - float(t_injection),
                                      np.shape(geos.x)))
    coords = as_t(np.stack([geos.x, geos.y, geos.z], axis=0))
    Omega_t = as_t(Omega)
    g = 1.0
    if doppler:
        g = as_t(gr.doppler_factor(
            geos, gr.azimuthal_velocity_vector(geos, np.asarray(Omega))))
    if np.ndim(J) > 0:
        J = as_t(J)
    dtau, Sigma = as_t(geos.dtau), as_t(geos.Sigma)
    data = emission_0.data.to(device)

    def render(t_chunk, data_chunk):
        warped, valid = velocity_warp_coords(
            coords, Omega_t, as_t(t_chunk), 0.0, t_geos_rel, 0.0,
            rot_axis=rot_axis, return_mask=True)
        grid = lambda d: utils.Grid3D(d, emission_0.start, emission_0.stop)
        if not is_movie:
            em = interpolate_coords(grid(data_chunk), warped)
        else:
            em = torch.stack([
                interpolate_coords(grid(data_chunk[i]),
                                   warped[i] if warped.ndim > 4 else warped)
                for i in range(data_chunk.shape[0])])
        em = torch.where(valid, em, torch.zeros_like(em))
        return gr.radiative_transfer(apply_stokes_factors(em, J), g, dtau,
                                     Sigma)

    if t_M.ndim == 0:
        return render(t_M, data)
    if frame_chunk is None:
        n = int(np.prod(np.shape(geos.x)))
        frame_chunk = max(1, RENDER_BUDGET_BYTES
                          // (_BYTES_PER_SAMPLE_FRAME * n))
    return torch.cat([
        render(t_M[i:i + frame_chunk],
               data[i:i + frame_chunk] if is_movie else data)
        for i in range(0, nt, frame_chunk)])


def propogate_flatspace_emission(emission_0, Omega_3D, t_frames,
                                 t_start_obs=None, rot_axis=(0, 0, 1),
                                 M=consts.sgra_mass, device='cuda'):
    """Advect a flat-space 3D field rigidly through time (reference
    emission.py:325-337): each frame samples `emission_0` (a Grid3D) at
    its grid points rotated back by Omega_3D (t - t_start_obs), zero
    before t_start_obs (the first frame unless given). Returns
    (nt, nx, ny, nz) on `device`."""
    coords = _as_tensor(np.stack(emission_0.meshgrid(), axis=0), device)
    if t_start_obs is None:
        t_start_obs = np.atleast_1d(np.asarray(t_frames))[0]
    warped, valid = velocity_warp_coords(
        coords, _as_tensor(Omega_3D, device), t_frames, t_start_obs, 0.0,
        0.0, rot_axis=rot_axis, M=M, return_mask=True)
    out = interpolate_coords(emission_0, warped)
    return torch.where(valid, out, torch.zeros_like(out))


def grf_to_image_plane(grf, geos, Omega, J, diameter_M, alpha=2.0,
                       H_r=0.075, device='cuda'):
    """A Gaussian-random-field accretion disk seen through the geodesics
    (reference emission.py:340-357): exp(alpha grf) under a Gaussian
    envelope of FWHM diameter_M, inflated to 3D with scale height H_r r
    (utils.expand_3d) and rendered frame by frame with
    image_plane_dynamics(slow_light=False) on `device`. grf: (ny, nx) or
    (nt, ny, nx). Returns ([nt,] [nstokes,] na, nb)."""
    fov_M = float(geos.alpha[-1, 0] - geos.alpha[0, 0])
    grf = _as_tensor(grf, device)
    gaussian = utils.gaussian_field(
        [grf.shape[-2], grf.shape[-1]], [0, 0], std=diameter_M / 2.355,
        fov=fov_M)
    movie = torch.exp(alpha * grf) * gaussian.data.to(device)
    if movie.ndim == 2:
        movie = movie[None]
    emission = utils.expand_3d(movie, fov_xy=fov_M, fov_z=fov_M, H_r=H_r)
    out = torch.stack([image_plane_dynamics(
        utils.Grid3D(frame, emission.start, emission.stop), geos, Omega,
        0.0, 0.0, J, slow_light=False, device=device)
        for frame in emission.data])
    return out[0] if out.shape[0] == 1 else out


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
