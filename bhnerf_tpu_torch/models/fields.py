"""Neural emission field: the NeRF MLP and its predictor.

PyTorch counterpart of the main-path subset of
`bhnerf_tpu/models/fields.py`: `safe_sin`, `posenc`, the MLP with its
skip connection (:93-127) as an `nn.Module`, and `NeRFPredictor`
(:133-225). The predictor is a frozen configuration; its parameters are
a `NeRFParams` module made by `init_params` (he-uniform, from an explicit
`torch.Generator`) or copied from the JAX package's pytree by
`params_from_jax`.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch
from torch import nn

from bhnerf_tpu_torch import emission as emission_lib


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


def posenc_feature_dim(in_dim, deg):
    return in_dim * (1 + 2 * deg)


def skip_after(i, net_depth, do_skip):
    """F is concatenated after layer i (reference fields.py:124)."""
    skip_layer = net_depth // 2
    return do_skip and i > 0 and skip_layer > 0 and i % skip_layer == 0


class MLP(nn.Module):
    """ReLU MLP whose input is concatenated back after layer net_depth // 2
    (reference network.py:18-64). layers[i] is the reference's dense_i."""

    def __init__(self, in_dim, net_depth=4, net_width=128, out_channel=1,
                 do_skip=True, device=None, dtype=torch.float32):
        super().__init__()
        self.net_depth = net_depth
        self.do_skip = do_skip
        dims = []
        dim = in_dim
        for i in range(net_depth):
            dims.append((dim, net_width))
            dim = net_width + (in_dim if skip_after(i, net_depth, do_skip)
                               else 0)
        dims.append((dim, out_channel))
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

    def forward(self, x):
        inputs = x
        for i in range(self.net_depth):
            x = torch.relu(self.layers[i](x))
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
    # matmul precision of the fused kernels: 'bfloat16' rounds the matmul
    # operands to bf16 and accumulates in f32; parameters stay float32
    compute_dtype: str = 'float32'
    learn_injection: bool = False

    def _mlp(self, dtype):
        return MLP(posenc_feature_dim(3, self.posenc_deg), self.net_depth,
                   self.net_width, self.out_channel, self.do_skip,
                   dtype=dtype)

    def init_params(self, generator=None, device='cpu', dtype=torch.float32):
        """Fresh he-uniform parameters drawn from `generator` (a CPU
        generator: the draw happens on the host, so a seed gives the same
        weights on every device)."""
        mlp = self._mlp(dtype)
        mlp.reset_parameters(generator)
        t_inj = (torch.zeros((), dtype=dtype)
                 if self.learn_injection else None)
        return NeRFParams(mlp, t_inj).to(device)

    def params_from_jax(self, np_params, device='cpu', dtype=torch.float32):
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
        out = params.mlp(features)
        em = torch.sigmoid(out[..., 0] - 10.0)
        em = emission_lib.fill_unsupervised_emission(
            em, coords, self.rmin, self.rmax, self.z_width)
        return torch.where(valid, em, torch.zeros_like(em))

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
