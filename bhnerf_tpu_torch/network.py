"""Reference-API facade for the model and loss layer.

PyTorch counterpart of `bhnerf_tpu/network.py`: the reference exposes
models, losses and steps under `bhnerf.network`; here they live in
`bhnerf_tpu_torch.models.fields` and `bhnerf_tpu_torch.train.step`,
re-exported under the reference names, with the few small utilities that
have no better home.
"""
import numpy as np
import torch
from torch import nn

from bhnerf_tpu_torch.models.fields import (GRID_Predictor, GridPredictor,
                                            NeRF_Predictor, NeRFPredictor,
                                            apply_mlp, expected_sin,
                                            init_mlp_params,
                                            integrated_posenc, posenc,
                                            safe_sin, sample_3d_grid)
from bhnerf_tpu_torch.train.step import (image_plane_prediction,
                                         loss_fn_eht, loss_fn_image,
                                         raytracing_args)


def sample_checkpoint_3d(checkpoint_dir, t_frame=0, t_start_obs=0, Omega=0,
                         fov=None, coords=None, resolution=64, chunk=-1,
                         device='cuda'):
    """The 3D emission volume of the latest checkpoint under
    `checkpoint_dir`, sampled on `device` (reference network.py:842-848):
    the checkpoint's predictor (its yaml) and params through
    sample_3d_grid."""
    from bhnerf_tpu_torch.train.state import restore_params
    predictor = NeRFPredictor.from_yml(checkpoint_dir)
    params = restore_params(checkpoint_dir,
                            predictor.init_params(device=device))
    return sample_3d_grid(predictor, params, t_frame, t_start_obs, Omega,
                          fov, coords, resolution, chunk)


def image_plane_checkpoint(raytracing_args, checkpoint_dir, t, rmin=0.0,
                           rmax=np.inf, batchsize=20):
    """Re-render the image plane from a checkpoint (reference
    network.py:896-906): alma.image_plane_checkpoint."""
    from bhnerf_tpu_torch import alma
    return alma.image_plane_checkpoint(raytracing_args, checkpoint_dir, t,
                                       rmin, rmax, batchsize)


def tv_reg(predictor, params, coords, lam=1.0):
    """Total-variation-style regularizer: lam times the sum of |d emission /
    d x| over the points `coords` (reference network.py:908-933, which is
    broken upstream by an undefined `lam`; here lam is an argument).
    coords: (n, 3), or the component-leading (3, ...) layout of
    velocity_warp_coords and domain_mask. The points are independent, so
    one backward pass of the summed emission gives every point's
    gradient."""
    device = next(params.parameters()).device
    coords = torch.as_tensor(np.asarray(coords), dtype=torch.float32,
                             device=device)
    if coords.shape[0] == 3 and coords.shape[-1] != 3:
        # (3, ...): reshape(-1, 3) would interleave the components into
        # fake points
        coords = torch.movedim(coords, 0, -1)
    pts = coords.reshape(-1, 3).detach().requires_grad_(True)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    em = predictor.emission_at(params, pts, valid, pts.T)
    (grads,) = torch.autograd.grad(em.sum(), pts, create_graph=True)
    return lam * torch.sum(torch.abs(grads))


def _flatten_dict(d, prefix=()):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten_dict(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten_dict(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def flattened_traversal(fn):
    """Parameter-path mask builder (reference network.py:935-939): the
    returned function maps a nested dict, or a module's parameters by
    their dotted names, to the same nesting of fn(path, value), path the
    tuple of keys."""
    def mask(data):
        if isinstance(data, nn.Module):
            data = _unflatten_dict({tuple(name.split('.')): p for name, p
                                    in data.named_parameters()})
        flat = _flatten_dict(data)
        return _unflatten_dict({k: fn(k, v) for k, v in flat.items()})

    return mask
