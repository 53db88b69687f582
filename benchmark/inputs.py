"""What the benchmark makes from `--seed` and hands to both sides: the
frame times, the target data, the initial weights and the screen grids
of the sub-pixel variants. Nothing here imports the program."""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.metrics import _work
from benchmark.reference import physics


def stream(seed, purpose):
    """A numpy generator for one purpose of one seed; the purposes never
    share draws, whatever the seed (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2**64, int(seed) // 2**64, purpose]))


# the draws' purposes
TARGET, JITTER, PIXELS, WEIGHTS = 1, 2, 3, 4


def rmin(cfg):
    """The inner radius of the supervised shell (M): a number, or the
    prograde ISCO of the spin."""
    return (float(physics.isco_pro(cfg['spin'])) if cfg['rmin'] == 'ISCO'
            else float(cfg['rmin']))


def initial_weights(cfg, seed, device):
    """He-uniform weights (out, in) with zero biases, drawn on `device`
    in one call from a generator seeded by `seed`, in float32: a list of
    (weight, bias) per layer."""
    dims = _work.mlp_dims(3 * (1 + 2 * cfg['posenc_deg']), cfg['net_depth'],
                          cfg['net_width'])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(stream(seed, WEIGHTS).integers(2**63)))
    u = torch.rand(sum(i * o for i, o in dims), generator=gen, device=device)
    layers, at = [], 0
    for d_in, d_out in dims:
        w = u[at:at + d_in * d_out].view(d_out, d_in)
        at += d_in * d_out
        layers.append(((2.0 * w - 1.0) * math.sqrt(6.0 / d_in),
                       torch.zeros(d_out, device=device)))
    return layers


def frame_times_hr(cfg):
    """The frame times in hours (float32): `num_frames` frames spread
    over `frames_span_M` gravitational times, or at `cadence_s` seconds,
    from `t_start_obs`."""
    n, t0 = cfg['num_frames'], cfg['t_start_obs']
    if 'frames_span_M' in cfg:
        t = t0 + np.linspace(0.0, cfg['frames_span_M'] * physics.gm_c3_hours(),
                             n)
    else:
        t = t0 + np.arange(n) * cfg['cadence_s'] / 3600.0
    return t.astype(np.float32)


def targets(cfg, seed):
    """The data the fit is held to: for the 'full' loss a movie of
    uniform draws in [0, 1) (num_frames, num_alpha, num_beta); for the
    'lc' loss the seeded stand-in lightcurve (num_frames, 3): the
    intensity prior and a Q-U loop of `qu_period_min` minutes with
    Gaussian noise. float32."""
    rng = stream(seed, TARGET)
    n = cfg['num_frames']
    if cfg['loss'] == 'full':
        return rng.random((n, cfg['num_alpha'], cfg['num_beta']),
                          dtype=np.float32)
    t = frame_times_hr(cfg).astype(np.float64)
    phase = 2 * np.pi * (t - t[0]) * 60.0 / cfg['qu_period_min']
    amp, noise = cfg['qu_amplitude'], cfg['qu_noise']
    q = amp * np.cos(phase) + noise * rng.standard_normal(n)
    u = amp * np.sin(phase) + noise * rng.standard_normal(n)
    return np.stack([np.full(n, cfg['I_prior']), q, u], -1).astype(np.float32)


def screen_axes(cfg, variants, seed):
    """The (alpha, beta) axes of each variant's screen: the regular grid
    for one variant, else each drawn with a sub-pixel jitter, variant
    after variant and alpha before beta, from one generator (the draw
    order of the port's `subpixel_jittered_axes`), which the benchmark
    hands to the program as its `rng`."""
    fov = cfg['fov_M']
    na, nb = cfg['num_alpha'], cfg['num_beta']
    a = np.linspace(-fov / 2, fov / 2, na)
    b = np.linspace(-fov / 2, fov / 2, nb)
    if variants == 1:
        return [(a, b)]
    rng = stream(seed, JITTER)
    out = []
    for _ in range(variants):
        ja = a + (rng.random(na) - 0.5) * fov / (na - 1)
        jb = b + (rng.random(nb) - 0.5) * fov / (nb - 1)
        out.append((ja, jb))
    return out
