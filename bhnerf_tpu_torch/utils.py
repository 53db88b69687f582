"""Array utilities: metrics, grids, rotations, broadcasting.

PyTorch counterpart of a subset of `bhnerf_tpu/utils.py`: `mse`, `psnr`,
`normalize`, the `Grid3D` container, `linspace_grid`, `gaussian_field`,
`rotation_matrix`, `world_to_image_coords`, `expand_dims` and
`intensity_to_nchw` (numpy and matplotlib, for tensorboard). The rest of
that module (random fields, FFT helpers, `expand_3d`) is not ported yet.
"""
from __future__ import annotations

import dataclasses

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
