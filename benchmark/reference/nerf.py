"""The plain reference of a NeRF fit's gradient steps, in PyTorch.

Each step: the frames' times in M, the velocity warp of every in-domain
sample (the configuration's emission shell), the positional encoding
sin/cos(2^i x), the MLP with its mid-network skip, sigmoid(out - 10), the
radiative transfer sum g^2 * emission * dtau * Sigma (times the Stokes
factors J) per pixel ('full': images) or over the screen ('lc': a
lightcurve per Stokes component), the chi-square, its gradient by
autograd and one Adam update with the linearly decaying learning rate.

`precision` is 'float32' (IEEE: TF32 off) or 'tf32', the control: every
matrix product, forward and backward, takes operands rounded to TF32's
10-bit mantissa and accumulates in float32, as a TF32 tensor core does,
on any device. The module imports nothing of the program.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def round_tf32(x):
    """x rounded to the nearest value with a 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return round_tf32(x) @ round_tf32(w).T

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(w), g.T @ round_tf32(x)


def linear(x, w, b, precision):
    """x (n, in) @ w (out, in)^T + b in the given precision."""
    if precision == 'tf32':
        return _TF32Linear.apply(x, w) + b
    return x @ w.T + b


@contextlib.contextmanager
def ieee_float32():
    """Matrix products in IEEE float32 inside the scope."""
    mm = torch.backends.cuda.matmul
    prev = mm.fp32_precision
    mm.fp32_precision = 'ieee'
    try:
        yield
    finally:
        mm.fp32_precision = prev


def learning_rate(cfg, count):
    """The linear decay from lr_init to lr_final over num_iters updates,
    at update `count` (0-based)."""
    frac = 1.0 - min(count, cfg['num_iters']) / cfg['num_iters']
    return (cfg['lr_init'] - cfg['lr_final']) * frac + cfg['lr_final']


def domain(coords, rmin, rmax, z_width):
    r2 = torch.sum(coords * coords, dim=0)
    return (r2 >= rmin**2) & (r2 <= rmax**2) & (torch.abs(coords[2])
                                                 <= z_width)


class Problem:
    """One variant's in-domain samples on the device: coords (3, N),
    Omega (N,), t_geos (N,), the transfer weights W (nstokes, N) and each
    sample's pixel."""

    def __init__(self, dense, rmin, rmax, z_width, device):
        f = lambda k: torch.as_tensor(np.asarray(dense[k], np.float32),
                                      device=device)
        coords = f('coords').reshape(3, -1)
        keep = domain(coords, rmin, rmax, z_width)
        idx = torch.nonzero(keep).flatten()
        ngeo = dense['coords'].shape[-1]
        self.coords = coords[:, idx]
        take = lambda x: x.reshape(-1)[idx]
        self.omega = (take(f('Omega')) if np.ndim(dense['Omega'])
                      else f('Omega').expand(idx.numel()))
        self.t_geos = take(f('t_geos_rel'))
        w = take(f('g')) ** 2 * take(f('dtau')) * take(f('Sigma'))
        J = dense['J']
        self.W = (torch.stack([take(j) for j in f('J')]) * w if np.ndim(J)
                  else (w * float(J))[None])
        self.pixel = idx // ngeo
        self.npix = int(np.prod(dense['coords'].shape[1:3]))


def emission(layers, prob, t_M, scale, deg, precision):
    """(frames, N) emission of the warped field at the samples."""
    tM = t_M[:, None] + prob.t_geos[None]
    valid = tM >= 0.0
    theta = torch.where(valid, tM, torch.zeros_like(tM)) * prob.omega
    c, s = torch.cos(theta), torch.sin(theta)
    x, y, z = prob.coords
    v = valid.float() / scale
    w = torch.stack([(c * x + s * y) * v, (c * y - s * x) * v,
                     z.expand_as(c) * v], dim=-1)             # (F, N, 3)
    feats = [w] + [torch.sin(2.0**i * w) for i in range(deg)] \
        + [torch.cos(2.0**i * w) for i in range(deg)]
    f = torch.cat(feats, dim=-1).reshape(-1, 3 * (1 + 2 * deg))
    depth = len(layers) - 1
    h = f
    for i in range(depth):
        h = torch.relu(linear(h, *layers[i], precision))
        if i > 0 and depth // 2 > 0 and i % (depth // 2) == 0:
            h = torch.cat([h, f], dim=-1)
    out = linear(h, *layers[depth], precision)[:, 0]
    return torch.sigmoid(out - 10.0).reshape(valid.shape) * valid


def loss(cfg, layers, prob, t_M, target, sigma, precision):
    em = emission(layers, prob, t_M, cfg['fov_M'] / 2, cfg['posenc_deg'],
                  precision)
    if cfg['loss'] == 'full':
        img = torch.zeros((em.shape[0], prob.npix), device=em.device)
        img = img.index_add(1, prob.pixel, em * prob.W[0])
        return torch.sum(((img - target.reshape(img.shape)) / sigma) ** 2)
    lc = linear(em, prob.W, 0.0, precision)                 # (F, nstokes)
    return torch.sum(((lc - target) / sigma) ** 2)


def steps(cfg, weights0, dense, t_frames_hr, t_start_hr, t_to_M, target,
          indices, variants, rmin, device, precision='float32'):
    """The reference's steps from `weights0` [(w, b)] on the frame
    batches `indices` and variants `variants`: ([loss of each step], the
    first step's gradient of every leaf, every leaf after the last step),
    leaves in the order weight, bias of each layer, on the host."""
    with ieee_float32():
        layers = [(w.to(device).clone().requires_grad_(),
                   b.to(device).clone().requires_grad_())
                  for w, b in weights0]
        leaves = [p for wb in layers for p in wb]
        m = [torch.zeros_like(p) for p in leaves]
        v = [torch.zeros_like(p) for p in leaves]
        probs = {}
        t_all = torch.as_tensor(t_frames_hr, device=device)
        tgt_all = torch.as_tensor(target, device=device)
        sigma = torch.as_tensor(np.asarray(cfg['sigma'], np.float32),
                                device=device)
        losses, grad1 = [], None
        for k, (idx, var) in enumerate(zip(indices, variants)):
            if var not in probs:
                probs[var] = Problem(dense[var], rmin, cfg['fov_M'] / 2,
                                     cfg['z_width'], device)
            idx = torch.as_tensor(idx, device=device)
            t_M = (t_all[idx] - t_start_hr) * t_to_M
            value = loss(cfg, layers, probs[var], t_M, tgt_all[idx], sigma,
                         precision)
            grads = torch.autograd.grad(value, leaves)
            losses.append(float(value.detach()))
            if grad1 is None:
                grad1 = [g.detach().cpu() for g in grads]
            lr = learning_rate(cfg, k)
            with torch.no_grad():
                for p, g, mi, vi in zip(leaves, grads, m, v):
                    mi.mul_(BETA1).add_(g, alpha=1 - BETA1)
                    vi.mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                    bc1 = 1 - BETA1 ** (k + 1)
                    bc2 = 1 - BETA2 ** (k + 1)
                    denom = (vi.sqrt() / bc2 ** 0.5).add_(EPS)
                    p.addcdiv_(mi, denom, value=-lr / bc1)
        return losses, grad1, [p.detach().cpu() for p in leaves]
