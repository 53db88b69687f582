"""Array utilities: metrics, grids, rotations, broadcasting.

PyTorch counterpart of `bhnerf_tpu/utils.py` without its JAX-only
helpers: `mse`, `psnr`, `normalize`, the `Grid3D` container,
`linspace_grid`, `gaussian_field`, `rotation_matrix`,
`spherical_coords_to_rotation_axis`, `world_to_image_coords`,
`expand_dims`, `expand_3d`, `intensity_to_nchw` (numpy and matplotlib,
for tensorboard), `anti_aliasing_filter`, `gaussian_random_field` and the
FFT helpers `next_power_of_two` and `fft_transform`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def mse(true, est):
    """Mean squared error, with numpy on the host (reference utils.py:52)."""
    return float(np.mean((_numpy(true) - _numpy(est)) ** 2))


def psnr(true, est):
    """Peak SNR in dB (reference utils.py:57)."""
    return float(10.0 * np.log10(np.max(_numpy(true)) ** 2
                                 / mse(true, est)))


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def normalize(vector):
    vector = np.asarray(vector, dtype=np.float64)
    return vector / np.sqrt(np.dot(vector, vector))


@dataclasses.dataclass
class Grid3D:
    """A scalar field sampled on a regular grid (reference utils.py:72-139,
    the stand-in for the original's xarray fields). `data` is a tensor of
    shape (nx, ny, nz), or (nt, nx, ny, nz) for a movie; the grid spans
    [start, stop] along each axis with linspace coordinates (endpoint
    included)."""

    data: torch.Tensor
    start: tuple
    stop: tuple

    @property
    def spatial_ndim(self):
        return len(self.start)

    @property
    def spatial_shape(self):
        return tuple(self.data.shape[-self.spatial_ndim:])

    @property
    def fov(self):
        return tuple(sp - st for st, sp in zip(self.start, self.stop))

    def coord_1d(self, axis):
        n = self.spatial_shape[axis]
        return np.linspace(self.start[axis], self.stop[axis], n)

    def meshgrid(self):
        """The grid's coordinates: one numpy array per axis, 'ij'
        indexing."""
        return np.meshgrid(*(self.coord_1d(i)
                             for i in range(self.spatial_ndim)),
                           indexing='ij')

    def integrate(self):
        """Volume integral by the trapezoid rule, innermost axis first, in
        the dtype of `data` (reference utils.py:120-126)."""
        out = self.data
        for axis in reversed(range(self.spatial_ndim)):
            coord = torch.as_tensor(self.coord_1d(axis), dtype=out.dtype,
                                    device=out.device)
            out = torch.trapezoid(out, coord, dim=-1)
        return out

    def __mul__(self, other):
        return Grid3D(self.data * other, self.start, self.stop)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return Grid3D(self.data / other, self.start, self.stop)


def linspace_grid(num, start=-0.5, stop=0.5):
    """N-d meshgrid coordinates (reference utils.py:141-148): a list of
    len(num) numpy arrays, each shaped like `num`."""
    num = np.atleast_1d(num)
    axes = [np.linspace(start, stop, int(n)) for n in num]
    return np.meshgrid(*axes, indexing='ij')


def gaussian_field(resolution, center, std, fov=1.0, std_clip=np.inf):
    """Gaussian blob on a regular grid (reference utils.py:151-165):
    computed in float64 with numpy and cast to a float32 tensor on the
    host, as the reference's jnp.asarray casts it."""
    resolution = tuple(int(n) for n in np.atleast_1d(resolution))
    if np.isscalar(std):
        std = (std,) * len(resolution)
    if len(resolution) != len(center):
        raise ValueError('resolution and center must have the same length')
    coords = linspace_grid(resolution, -fov / 2.0, fov / 2.0)
    r2 = sum(((c - mu) / s) ** 2 for c, mu, s in zip(coords, center, std))
    data = np.exp(-0.5 * r2)
    data = np.where(data > np.exp(-0.5 * std_clip**2), data, 0.0)
    start = (-fov / 2.0,) * len(resolution)
    stop = (fov / 2.0,) * len(resolution)
    return Grid3D(torch.as_tensor(data, dtype=torch.float32), start, stop)


def rotation_matrix(axis, angle):
    """Euler-Rodrigues rotation matrix (reference utils.py:97-132).

    axis: 3-vector; angle: tensor of any shape. Returns (3, 3, *angle.shape)
    in the dtype and on the device of `angle`.
    """
    angle = torch.as_tensor(angle)
    if not angle.is_floating_point():
        angle = angle.to(torch.get_default_dtype())
    axis = torch.as_tensor(axis, dtype=angle.dtype, device=angle.device)
    axis = axis / torch.sqrt(torch.dot(axis, axis))

    a = torch.cos(angle / 2.0)
    b = -axis[0] * torch.sin(angle / 2.0)
    c = -axis[1] * torch.sin(angle / 2.0)
    d = -axis[2] * torch.sin(angle / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    row0 = torch.stack([aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)])
    row1 = torch.stack([2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)])
    row2 = torch.stack([2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc])
    return torch.stack([row0, row1, row2])


def spherical_coords_to_rotation_axis(theta, phi):
    """A spherical direction (theta, phi) -> (rot_axis, rot_angle) of the
    orbit through it (reference utils.py:191-206): rot_axis is a numpy
    3-vector, rot_angle is phi. At the poles (theta = 0 or pi) the orbit
    plane is the equator and the axis is +-z."""
    z_axis = np.array([0.0, 0.0, 1.0])
    r_vector = np.array([np.cos(phi) * np.sin(theta),
                         np.sin(phi) * np.sin(theta),
                         np.cos(theta)])
    rot_axis_prime = np.cross(r_vector, z_axis)
    if np.linalg.norm(rot_axis_prime) < 1e-12:
        # the cross product vanishes and normalising it would give NaNs
        return np.array([0.0, 0.0, np.sign(np.cos(theta)) or 1.0]), phi
    # a float32 rotation, as the reference builds it
    rot = rotation_matrix(rot_axis_prime,
                          torch.tensor(np.pi / 2, dtype=torch.float32))
    return rot.numpy() @ r_vector, phi


def world_to_image_coords(coords, fov, npix):
    """World coordinates (..., d) -> fractional grid indices (..., d)
    (reference utils.py:209-215)."""
    return torch.stack([(coords[..., i] + fov[i] / 2.0) / fov[i]
                        * (npix[i] - 1) for i in range(coords.shape[-1])],
                       dim=-1)


def expand_dims(x, ndim, axis=0):
    """Insert size-1 dims until x.ndim == ndim (reference utils.py:215-219)."""
    x = torch.as_tensor(x)
    for _ in range(ndim - x.ndim):
        x = x.unsqueeze(min(axis, x.ndim) if axis >= 0 else axis)
    return x


def expand_3d(movie, fov_xy, fov_z, H_r=0.05, std=0.2, std_clip=3, nz=64):
    """Inflate a 2D movie (nt, nx, ny) into 3D (reference utils.py:
    226-240): each pixel spread over nz heights by a Gaussian of scale
    height H_r times its radius (std where H_r is 0), clipped at std_clip
    scale heights. The profile is computed in float64 numpy and applied in
    float32 on the movie's device; returns a Grid3D (nt, nx, ny, nz)."""
    movie = torch.as_tensor(movie)
    nt, nx, ny = movie.shape
    x = np.linspace(-fov_xy / 2, fov_xy / 2, nx)
    y = np.linspace(-fov_xy / 2, fov_xy / 2, ny)
    z = np.linspace(-fov_z / 2, fov_z / 2, nz)
    X, Y = np.meshgrid(x, y, indexing='ij')
    H = H_r * np.sqrt(X**2 + Y**2) if H_r != 0 else np.full_like(X, std)
    gauss = np.exp(-0.5 * z[None, None, :] ** 2 / H[..., None] ** 2)
    gauss = np.where(gauss > np.exp(-0.5 * std_clip**2), gauss, 0.0)
    data = movie[..., None] * torch.as_tensor(gauss, dtype=torch.float32,
                                              device=movie.device)[None]
    return Grid3D(data, (-fov_xy / 2, -fov_xy / 2, -fov_z / 2),
                  (fov_xy / 2, fov_xy / 2, fov_z / 2))


def intensity_to_nchw(intensity, cmap='viridis', gamma=0.5):
    """Grayscale volume -> NCHW image stack for tensorboard (reference
    utils.py:243-251): the volume normalised to [0, 1], raised to `gamma`
    and coloured by `cmap`; one image per slice of the last axis.
    matplotlib is imported here, not with the module."""
    import matplotlib.pyplot as plt
    cm = plt.get_cmap(cmap)
    intensity = np.asarray(intensity)
    lo, hi = np.min(intensity), np.max(intensity)
    norm = ((intensity - lo) / max(hi - lo, 1e-30)) ** gamma
    return np.moveaxis(cm(norm)[..., :3], (0, 1, 2, 3), (3, 2, 0, 1))


def anti_aliasing_filter(image_plane, window):
    """Blur the last two axes of `image_plane` by `window` through the FFT
    (reference utils.py:254-258), with torch.fft on the device of the
    image. Returns the real part."""
    image_plane = torch.as_tensor(image_plane)
    window = torch.as_tensor(window, dtype=image_plane.dtype,
                             device=image_plane.device)
    fourier = (torch.fft.fft2(torch.fft.ifftshift(image_plane, dim=(-2, -1)))
               * torch.fft.fft2(torch.fft.ifftshift(window)))
    return torch.fft.ifftshift(torch.fft.ifft2(fourier), dim=(-2, -1)).real


def grf_from_noise(noise, slope=3.0, std=1.0, temporal_corr=0.9):
    """The map from complex white noise to the field of
    gaussian_random_field (reference utils.py:273-301), in float64 with
    torch on the host: each frame's noise shaped by the power law
    P(k) ~ k^-slope, inverse transformed and normalised to zero mean and
    standard deviation `std`. noise: complex (ny, nx) for one field, or
    (nt, ny, nx) independent draws of a movie, whose spectral noise then
    follows an AR(1) process with coefficient `temporal_corr` along the
    leading axis (the first frame takes its draw, frame i
    temporal_corr * noise_{i-1} + sqrt(1 - temporal_corr^2) * draw_i).
    Returns a float64 tensor shaped like `noise`."""
    noise = torch.as_tensor(noise).to(torch.complex128)
    spatial = noise.shape[-2:]
    kgrid = np.meshgrid(*(np.fft.fftfreq(n) for n in spatial), indexing='ij')
    knorm = np.sqrt(sum(k**2 for k in kgrid))
    knorm[0, 0] = np.inf
    amplitude = torch.as_tensor(knorm ** (-slope / 2.0))

    def to_field(frame_noise):
        field = torch.fft.ifft2(amplitude * frame_noise).real
        return field / (np.std(field.numpy()) + 1e-12) * std

    if noise.ndim == 2:
        return to_field(noise)
    rho = temporal_corr
    frame_noise = noise[0]
    frames = [to_field(frame_noise)]
    for draw in noise[1:]:
        frame_noise = rho * frame_noise + np.sqrt(1 - rho**2) * draw
        frames.append(to_field(frame_noise))
    return torch.stack(frames)


def gaussian_random_field(generator, shape, slope=3.0, std=1.0,
                          temporal_corr=0.9):
    """Isotropic power-law Gaussian random field (the accretion-disk GRF
    of the reference's Synthetic-lightcurves notebooks; reference
    utils.py:261-301): P(k) ~ k^-slope, zero mean, standard deviation
    `std`. shape: 2D (ny, nx), or 3D (nt, ny, nx) for a movie stationary in
    time with AR(1) spectral noise of coefficient `temporal_corr`.
    generator: a torch.Generator on the CPU (the reference takes a PRNG
    key); each frame draws the real parts of its noise, then the
    imaginary parts. Returns a float32 tensor on the host, as the
    reference casts its float64 field."""
    shape = tuple(shape)
    frames = 1 if len(shape) == 2 else shape[0]
    draws = torch.randn((frames, 2, *shape[-2:]), generator=generator,
                        dtype=torch.float64)
    noise = torch.complex(draws[:, 0], draws[:, 1])
    field = grf_from_noise(noise[0] if len(shape) == 2 else noise, slope,
                           std, temporal_corr)
    return field.to(torch.float32)


def next_power_of_two(x):
    return 2 ** int(math.ceil(math.log2(x)))


def fft_transform(movies, fft_pad_factor=2):
    """Zero-padded, shifted 2D FFT of each frame (reference utils.py:
    304-319): the last two axes padded to the next power of two of
    fft_pad_factor times the larger side, with torch.fft on the device of
    `movies`. As in the reference, the shifts run over every axis."""
    movies = torch.as_tensor(movies)
    ny, nx = movies.shape[-2:]
    npad = next_power_of_two(fft_pad_factor * max(nx, ny))
    padx1 = padx2 = int(np.floor((npad - nx) / 2.0))
    pady1 = pady2 = int(np.floor((npad - ny) / 2.0))
    padx2 += 1 if nx % 2 else 0
    pady2 += 1 if ny % 2 else 0
    padded = torch.nn.functional.pad(movies, (padx1, padx2, pady1, pady2))
    return torch.fft.fftshift(torch.fft.fft2(torch.fft.ifftshift(padded)))
