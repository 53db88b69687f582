"""Array utilities needed by the velocity warp (rotations, broadcasting).

PyTorch counterpart of the main-path subset of `bhnerf_tpu/utils.py`:
`rotation_matrix` and `expand_dims`. The rest of that module (grids,
random fields, FFT helpers) is not ported yet.
"""
from __future__ import annotations

import torch


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


def expand_dims(x, ndim, axis=0):
    """Insert size-1 dims until x.ndim == ndim (reference utils.py:215-219)."""
    x = torch.as_tensor(x)
    for _ in range(ndim - x.ndim):
        x = x.unsqueeze(min(axis, x.ndim) if axis >= 0 else axis)
    return x
