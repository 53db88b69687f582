"""Neural emission fields: the NeRF MLP, the voxel grid and their
predictors.

PyTorch counterpart of `bhnerf_tpu/models/fields.py`: `safe_sin`,
`posenc`, `integrated_posenc` and `expected_sin` (:35-68), the MLP with
its skip connection (:93-127) as an `nn.Module` and as the functional
`init_mlp_params` / `apply_mlp` over the reference's `dense_i/{kernel
(in, out), bias}` dicts, `NeRFPredictor` (:133-225), `GridPredictor`
(:229-279) and `sample_3d_grid` (:282-312), with the reference's aliases
`NeRF_Predictor` and `GRID_Predictor`. A predictor is a frozen
configuration; its parameters are a module (`NeRFParams`, `GridParams`)
made by `init_params` (from an explicit `torch.Generator`) or copied from
the JAX package's pytree by `params_from_jax`, whose inverse is
`params_to_numpy`. These are plain PyTorch: the training path runs the
NeRF MLP inside the fused kernels (ReLU only, whatever `activation` is,
as the reference's), and the reference evaluates these entry points in
XLA, outside its Pallas kernels.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from bhnerf_tpu_torch import emission as emission_lib
from bhnerf_tpu_torch import units


def safe_sin(x):
    """Sine with range reduction (reference network.py:16)."""
    return torch.sin(torch.remainder(x, 100 * math.pi))


def posenc(x, deg):
    """NeRF positional encoding of degree `deg` (reference network.py:98-122):
    concat([x, sin(2^i x), cos(2^i x)]) via one sin call."""
    if deg == 0:
        return x
    scales = torch.tensor([2.0**i for i in range(deg)], dtype=x.dtype,
                          device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    four_feat = safe_sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    return torch.cat([x, four_feat], dim=-1)


def integrated_posenc(x, x_cov, max_deg, min_deg=0):
    """mip-NeRF integrated positional encoding (reference network.py:66-96):
    the expected sin and cos of 2^k x under a Gaussian of covariance
    x_cov (a scalar or the shape of x)."""
    x_cov = torch.as_tensor(x_cov, dtype=x.dtype, device=x.device)
    if x_cov.ndim == 0:
        x_cov = torch.full_like(x, float(x_cov))
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype,
                                 device=x.device)
    shape = (*x.shape[:-1], -1)
    y = (x[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (x_cov[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(torch.cat([y, y + 0.5 * math.pi], dim=-1),
                        torch.cat([y_var] * 2, dim=-1))


def expected_sin(x, x_var):
    """E[sin(X)] for X ~ N(x, x_var) (reference fields.py:67-68)."""
    return torch.exp(-0.5 * x_var) * safe_sin(x)


def posenc_feature_dim(in_dim, deg):
    return in_dim * (1 + 2 * deg)


def skip_after(i, net_depth, do_skip):
    """F is concatenated after layer i (reference fields.py:124)."""
    skip_layer = net_depth // 2
    return do_skip and i > 0 and skip_layer > 0 and i % skip_layer == 0


def _mlp_dims(in_dim, net_depth, net_width, out_channel, do_skip):
    """(in, out) of every layer, head last (reference fields.py:93-114)."""
    dims, dim = [], in_dim
    for i in range(net_depth):
        dims.append((dim, net_width))
        dim = net_width + (in_dim if skip_after(i, net_depth, do_skip)
                           else 0)
    dims.append((dim, out_channel))
    return dims


def init_mlp_params(generator, in_dim, net_depth=4, net_width=128,
                    out_channel=1, do_skip=True, dtype=torch.float32,
                    device='cuda'):
    """he_uniform-initialized MLP parameters as the reference's dict
    {'dense_i': {'kernel' (in, out), 'bias' (out,)}} (reference
    fields.py:93-114), drawn on the host from `generator` (matched in
    distribution, not bitwise), then moved to `device`."""
    params = {}
    for i, (d_in, d_out) in enumerate(_mlp_dims(in_dim, net_depth,
                                                 net_width, out_channel,
                                                 do_skip)):
        bound = math.sqrt(6.0 / d_in)
        kernel = torch.empty(d_in, d_out, dtype=dtype).uniform_(
            -bound, bound, generator=generator)
        params[f'dense_{i}'] = {'kernel': kernel.to(device),
                                'bias': torch.zeros(d_out, dtype=dtype,
                                                    device=device)}
    return params


def apply_mlp(params, x, net_depth=4, activation=torch.relu, do_skip=True):
    """The MLP of `init_mlp_params` with its mid-network skip connection
    (reference fields.py:117-127)."""
    inputs = x
    for i in range(net_depth):
        p = params[f'dense_{i}']
        x = activation(x @ p['kernel'] + p['bias'])
        if skip_after(i, net_depth, do_skip):
            x = torch.cat([x, inputs], dim=-1)
    p = params[f'dense_{net_depth}']
    return x @ p['kernel'] + p['bias']


class MLP(nn.Module):
    """MLP whose input is concatenated back after layer net_depth // 2
    (reference network.py:18-64), ReLU unless `forward` is given another
    activation. layers[i] is the reference's dense_i."""

    def __init__(self, in_dim, net_depth=4, net_width=128, out_channel=1,
                 do_skip=True, device=None, dtype=torch.float32):
        super().__init__()
        self.net_depth = net_depth
        self.do_skip = do_skip
        dims = _mlp_dims(in_dim, net_depth, net_width, out_channel, do_skip)
        self.layers = nn.ModuleList(
            nn.Linear(i, o, device=device, dtype=dtype) for i, o in dims)

    def reset_parameters(self, generator=None):
        """he_uniform weights, bound sqrt(6 / fan_in) like JAX's
        he_uniform (matched in distribution, not bitwise); zero biases."""
        with torch.no_grad():
            for layer in self.layers:
                nn.init.kaiming_uniform_(layer.weight, nonlinearity='relu',
                                         generator=generator)
                layer.bias.zero_()

    def forward(self, x, activation=torch.relu):
        inputs = x
        for i in range(self.net_depth):
            x = activation(self.layers[i](x))
            if skip_after(i, self.net_depth, self.do_skip):
                x = torch.cat([x, inputs], dim=-1)
        return self.layers[self.net_depth](x)


class NeRFParams(nn.Module):
    """Trainable parameters of a NeRFPredictor: the MLP and, with
    learn_injection, a scalar injection-time offset `t_injection`."""

    def __init__(self, mlp, t_injection=None):
        super().__init__()
        self.mlp = mlp
        if t_injection is None:
            self.register_parameter('t_injection', None)
        else:
            self.t_injection = nn.Parameter(t_injection)


def has_learned_injection(params):
    """True when params carry the learnable injection-time offset."""
    return getattr(params, 't_injection', None) is not None


def learned_t_injection(params, t_injection):
    """Injection time plus the learnable offset, when trained."""
    if has_learned_injection(params):
        return t_injection + params.t_injection
    return t_injection


@dataclasses.dataclass(frozen=True)
class NeRFPredictor:
    """Coordinate-based emission field with a velocity-warp time model
    (reference NeRF_Predictor, network.py:124-252)."""

    scale: float = 1.0
    rmin: float = 0.0
    rmax: float = float(np.inf)
    z_width: float = float(np.inf)
    posenc_deg: int = 3
    posenc_var: float = 2e-5
    net_depth: int = 4
    net_width: int = 128
    out_channel: int = 1
    do_skip: bool = True
    # the plain path's activation; the fused kernels are ReLU-only and
    # ignore it, as the reference's do
    activation: Callable[[Any], Any] = torch.relu
    # matmul precision of the fused kernels: 'bfloat16' rounds the matmul
    # operands to bf16 and accumulates in f32; parameters stay float32
    compute_dtype: str = 'float32'
    learn_injection: bool = False

    def _mlp(self, dtype):
        return MLP(posenc_feature_dim(3, self.posenc_deg), self.net_depth,
                   self.net_width, self.out_channel, self.do_skip,
                   dtype=dtype)

    def init_params(self, generator=None, device='cuda', dtype=torch.float32):
        """Fresh he-uniform parameters drawn from `generator` (a CPU
        generator: the draw happens on the host, so a seed gives the same
        weights on every device)."""
        mlp = self._mlp(dtype)
        mlp.reset_parameters(generator)
        t_inj = (torch.zeros((), dtype=dtype)
                 if self.learn_injection else None)
        return NeRFParams(mlp, t_inj).to(device)

    def params_from_jax(self, np_params, device='cuda', dtype=torch.float32):
        """NeRFParams from the JAX package's pytree
        {'dense_i': {'kernel' (in, out), 'bias' (out,)}, ['t_injection']},
        as numpy arrays: weight = kernel.T. Built on the host, then moved
        to `device`."""
        mlp = self._mlp(dtype)
        with torch.no_grad():
            for i, layer in enumerate(mlp.layers):
                p = np_params[f'dense_{i}']
                layer.weight.copy_(torch.as_tensor(
                    np.asarray(p['kernel']).T.copy(), dtype=dtype))
                layer.bias.copy_(torch.as_tensor(np.array(p['bias']),
                                                 dtype=dtype))
        t_inj = None
        if self.learn_injection:
            t_inj = torch.tensor(
                float(np_params.get('t_injection', 0.0)), dtype=dtype)
        return NeRFParams(mlp, t_inj).to(device)

    def emission_at(self, params, warped_coords, valid, coords):
        """Emission from already-warped coordinates + validity mask.

        warped_coords: (..., 3) canonical-frame positions; valid: (...)
        bool; coords: (3, ...) unwarped positions for the domain mask.
        """
        net_input = torch.where(valid[..., None], warped_coords,
                                torch.zeros_like(warped_coords))
        features = posenc(net_input / self.scale, self.posenc_deg)
        out = params.mlp(features, self.activation)
        em = torch.sigmoid(out[..., 0] - 10.0)
        em = emission_lib.fill_unsupervised_emission(
            em, coords, self.rmin, self.rmax, self.z_width)
        return torch.where(valid, em, torch.zeros_like(em))

    def __call__(self, params, t_frames, t_units, coords, Omega, t_start_obs,
                 t_geos, t_injection):
        """Emission of the warped field at every sample and frame
        (reference fields.py:189-198). coords: (3, ...) tensor; t_frames
        may be a units.Quantity."""
        t_injection = learned_t_injection(params, t_injection)
        warped, valid = emission_lib.velocity_warp_coords(
            coords, Omega, t_frames, t_start_obs, t_geos, t_injection,
            t_units=t_units, return_mask=True)
        return self.emission_at(params, warped, valid, coords)

    apply = __call__

    _YAML_KEYS = ('scale', 'rmin', 'rmax', 'z_width', 'posenc_deg',
                  'posenc_var', 'net_depth', 'net_width', 'out_channel',
                  'do_skip', 'compute_dtype', 'learn_injection')

    def save_params(self, directory, filename='NeRF_Predictor_params.yml'):
        import yaml
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        cfg = {k: getattr(self, k) for k in self._YAML_KEYS}
        cfg = {k: (float(v) if isinstance(v, (int, float, np.floating))
                   and k not in ('posenc_deg', 'net_depth', 'net_width',
                                 'out_channel', 'do_skip',
                                 'learn_injection') else v)
               for k, v in cfg.items()}
        with open(directory / filename, 'w') as f:
            yaml.dump(cfg, f)

    @classmethod
    def from_yml(cls, directory, filename='NeRF_Predictor_params.yml'):
        import yaml
        cfg = yaml.safe_load((Path(directory) / filename).read_text())
        inf_forms = {'.inf': np.inf, 'inf': np.inf,
                     '-.inf': -np.inf, '-inf': -np.inf}
        cfg = {k: inf_forms.get(v, v) if isinstance(v, str) else v
               for k, v in cfg.items()}
        return cls(**cfg)


class GridParams(nn.Module):
    """Trainable parameters of a GridPredictor: the voxel grid."""

    def __init__(self, grid):
        super().__init__()
        self.grid = nn.Parameter(grid)


@dataclasses.dataclass(frozen=True)
class GridPredictor:
    """Voxel-grid emission field with a trilinear lookup (reference
    GRID_Predictor, fields.py:229-279): a grid_res^3 grid over
    [-scale, scale]^3, looked up with map_coordinates(order=1, cval=0)
    semantics (an out-of-range corner counts as 0), then sigmoid(out - 10)
    and the domain fill. It has no MLP, so it trains on the plain path."""

    scale: float = 1.0
    rmin: float = 0.0
    rmax: float = float(np.inf)
    z_width: float = float(np.inf)
    grid_res: int = 64

    def init_params(self, generator=None, device='cuda', dtype=torch.float32):
        """The reference's start: every voxel at -10 (the generator is not
        drawn from)."""
        del generator
        return GridParams(torch.full((self.grid_res,) * 3, -10.0,
                                     dtype=dtype)).to(device)

    def params_from_jax(self, np_params, device='cuda', dtype=torch.float32):
        """GridParams from the JAX package's pytree {'grid': (R, R, R)}."""
        return GridParams(torch.as_tensor(np.array(np_params['grid']),
                                          dtype=dtype)).to(device)

    def emission_at(self, params, warped_coords, valid, coords):
        """Emission from already-warped coordinates + validity mask (as
        NeRFPredictor.emission_at)."""
        net_input = torch.where(valid[..., None], warped_coords,
                                torch.zeros_like(warped_coords))
        idx = (net_input + self.scale) / (2 * self.scale) * (
            self.grid_res - 1.0)
        out = emission_lib.map_coordinates_linear(params.grid, idx)
        em = torch.sigmoid(out - 10.0)
        em = emission_lib.fill_unsupervised_emission(
            em, coords, self.rmin, self.rmax, self.z_width)
        return torch.where(valid, em, torch.zeros_like(em))

    def __call__(self, params, t_frames, t_units, coords, Omega, t_start_obs,
                 t_geos, t_injection):
        """Emission of the warped grid at every sample and frame (reference
        fields.py:261-266)."""
        warped, valid = emission_lib.velocity_warp_coords(
            coords, Omega, t_frames, t_start_obs, t_geos, t_injection,
            t_units=t_units, return_mask=True)
        return self.emission_at(params, warped, valid, coords)

    apply = __call__

    _YAML_KEYS = ('scale', 'rmin', 'rmax', 'z_width', 'grid_res')

    def save_params(self, directory, filename='GRID_Predictor_params.yml'):
        import yaml
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        with open(directory / filename, 'w') as f:
            yaml.dump({k: getattr(self, k) for k in self._YAML_KEYS}, f)

    @classmethod
    def from_yml(cls, directory, filename='GRID_Predictor_params.yml'):
        import yaml
        cfg = yaml.safe_load((Path(directory) / filename).read_text())
        return cls(**cfg)


# the reference's class names
NeRF_Predictor = NeRFPredictor
GRID_Predictor = GridPredictor


def params_to_numpy(params):
    """The JAX package's parameter pytree of a NeRFParams or GridParams
    module, as numpy: {'dense_i': {'kernel' (in, out), 'bias' (out,)},
    ['t_injection']} or {'grid'}. The inverse of params_from_jax."""
    if isinstance(params, GridParams):
        return {'grid': params.grid.detach().cpu().numpy().copy()}
    out = {f'dense_{i}': {'kernel': layer.weight.detach().cpu().numpy().T
                          .copy(),
                          'bias': layer.bias.detach().cpu().numpy().copy()}
           for i, layer in enumerate(params.mlp.layers)}
    if has_learned_injection(params):
        out['t_injection'] = params.t_injection.detach().cpu().numpy().copy()
    return out


@torch.no_grad()
def sample_3d_grid(predictor, params, t_frame=0.0, t_start_obs=0.0,
                   Omega=0.0, fov=None, coords=None, resolution=64,
                   chunk=-1):
    """The trained field on a regular 3D grid (reference fields.py:282-312),
    evaluated on the parameters' device in chunks of `chunk` slices of
    the first axis (all at once when chunk < 0); returns a numpy array.
    A learned injection offset is dropped: the grid is sampled in the
    canonical frame, where a positive offset would mask the whole
    volume."""
    if coords is None and fov is not None:
        grid_1d = np.linspace(-fov / 2, fov / 2, resolution)
        coords = np.stack(np.meshgrid(grid_1d, grid_1d, grid_1d,
                                      indexing='ij'))
    elif coords is None:
        raise ValueError('Either coords or fov+resolution must be provided')
    t_units = t_frame.unit if isinstance(t_frame, units.Quantity) else None
    resolution = coords.shape[1]
    chunk = resolution if chunk < 0 else chunk
    if isinstance(params, NeRFParams):
        params = NeRFParams(params.mlp)
    device = next(params.parameters()).device
    put = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                    device=device)
    out = []
    for start in range(0, resolution, chunk):
        sl = slice(start, start + chunk)
        omega = put(Omega if np.isscalar(Omega) else np.asarray(Omega)[sl])
        out.append(predictor(params, t_frame, t_units, put(coords[:, sl]),
                             omega, t_start_obs, 0.0, 0.0).cpu().numpy())
    return np.concatenate(out, axis=0)
