"""How `correct` is decided: the numbers that compare the program's first
three steps and its ray constants with the plain reference, and their
limits (`benchmark/limits/<config>.json`).

The reference follows the program's dense ray constants (its table
stage's output, before the compaction): tracing every ray of a table in
float64 on the host takes longer than a run's window. So the numbers are
of two stages, each checked by itself:

* the steps: from the benchmark's own weights, on the frame batches and
  variants the program drew, the reference renders every in-domain
  sample of those constants (its own domain mask, warp, encoding, MLP,
  transfer sum, chi-square, autograd and Adam) and is compared by
  `loss` (the widest relative gap of the three steps' losses), `grad`
  (the first gradient, as Adam's first moment holds it after step 1, by
  the worst leaf) and `update` (the change of each leaf over the three
  steps, by the median leaf), each leaf's gap being the gap between the
  two norms of the leaf over the larger of the reference's norm of that
  leaf and of the median leaf. A leaf whose reference gradient is under
  a thousandth of the median leaf's is left out of `update` (Adam moves
  it by rounding alone). The worst leaf's change (`update_worst`) is
  shown and not compared: Adam's first steps move an element by about
  the learning rate whatever its gradient, so an element whose gradient
  is zero to rounding flips its step's sign on either side, and one flip
  in a 128 x 128 leaf reads 2.7e-5, as close to the control as a sound
  run can come;
* the tables: `tables`, for a sample of pixels drawn from the seed in
  every variant the steps used, the reference traces their rays in
  float64, derives their constants, and both sets of constants render
  one fixed smooth field, at the time of the last frame, over the
  reference's in-domain samples; `tables` is the widest gap of a pixel
  over the largest pixel, `tables_p90` the 90th percentile over pixels
  and Stokes components of each one's gap over its own value (floored
  at a hundredth of the largest pixel): the float32 device tracer
  departs from float64 on a few near-critical rays, which the widest gap
  reads and the percentile leaves out. For polarized constants the
  reference traces every ray of the variant's screen, since the B field
  is normalised over the whole screen's domain, and the images are
  compared as they come, their scale included. Each variant is traced in
  a process of its own.
"""
from __future__ import annotations

import json
import math
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import nerf, physics, tables

NAMES = ('loss', 'grad', 'update', 'tables', 'tables_p90')
LIMITS = Path(__file__).parent / 'limits'


def leaf_gaps(prog, ref):
    """Each leaf's |norm(prog) - norm(ref)| over max(norm(ref), the
    median leaf's norm(ref))."""
    p = np.array([float(torch.linalg.vector_norm(x)) for x in prog])
    r = np.array([float(torch.linalg.vector_norm(x)) for x in ref])
    return np.abs(p - r) / np.maximum(r, np.median(r))


def step_numbers(fit, record, ref):
    """`loss`, `grad`, `update` of the program's record against the
    reference's (losses, grad1, params3), and `update_worst`, the worst
    leaf's change, which is shown and not compared."""
    ref_losses, ref_grad1, ref_params3 = ref
    leaves0 = [x for wb in fit.weights0 for x in wb]
    loss = max(abs(p - r) / abs(r) for p, r in zip(record.losses, ref_losses))
    g = np.array([float(torch.linalg.vector_norm(x)) for x in ref_grad1])
    moved = [i for i in range(len(g)) if g[i] >= 1e-3 * np.median(g)]
    dp = [record.params3[i] - leaves0[i] for i in moved]
    dr = [ref_params3[i] - leaves0[i] for i in moved]
    update = leaf_gaps(dp, dr)
    return {'loss': float(loss),
            'grad': float(np.max(leaf_gaps(record.grad1, ref_grad1))),
            'update': float(np.median(update)),
            'update_worst': float(np.max(update))}


def reference_steps(fit, record, device, precision='float32'):
    cfg = fit.cfg
    return nerf.steps(cfg, fit.weights0, fit.dense, fit.t_frames,
                      cfg['t_start_obs'], 1.0 / physics.gm_c3_hours(),
                      fit.target, record.indices, record.variants,
                      inputs.rmin(cfg), device, precision)


def check_pixels(fit, variant):
    """The pixels of `variant` whose rays the table check traces."""
    cfg = fit.cfg
    npix = cfg['num_alpha'] * cfg['num_beta']
    rng = inputs.stream(fit.seed + 1000003 * variant, inputs.PIXELS)
    return np.sort(rng.choice(npix, cfg['check_pixels'], replace=False))


def program_constants(fit, variant, pixels):
    """The program's dense constants of `variant` at `pixels`."""
    out = {}
    for k, v in fit.dense[variant].items():
        v = np.asarray(v, np.float64)
        if v.ndim == 0:
            out[k] = np.full((len(pixels), fit.cfg['ngeo']), float(v))[None] \
                if k == 'J' else v
            continue
        lead = v.shape[:-3]
        out[k] = v.reshape(*lead, -1, v.shape[-1])[..., pixels, :]
    return out


def table_gap(fit, record, variant, pixels, ref_consts, prog_consts):
    cfg = fit.cfg
    rmax = cfg['fov_M'] / 2
    r2 = np.sum(ref_consts['coords'] ** 2, axis=0)
    keep = ((r2 >= inputs.rmin(cfg) ** 2) & (r2 <= rmax**2)
            & (np.abs(ref_consts['coords'][2]) <= cfg['z_width']))
    t_M = (float(fit.t_frames[-1]) - cfg['t_start_obs']) \
        / physics.gm_c3_hours()
    ref_img = tables.probe_image(ref_consts, keep, t_M, rmax)
    prog_img = tables.probe_image(prog_consts, keep, t_M, rmax)
    top = np.max(np.abs(ref_img[0]))
    gap = np.abs(prog_img - ref_img)
    own = gap / (np.abs(ref_img) + 0.01 * top)
    return float(np.max(gap) / top), float(np.percentile(own, 90))


def table_numbers(fit, record, program=None):
    """`tables` over the variants of the check steps; `program(variant,
    pixels)` gives the constants held against the reference (the
    program's own by default)."""
    program = program or (lambda v, px: program_constants(fit, v, px))
    variants = sorted(set(record.variants))
    pixels = [check_pixels(fit, v) for v in variants]
    # the reference traces each variant in a process of its own
    with ProcessPoolExecutor(len(variants),
                             mp_context=mp.get_context('spawn')) as pool:
        refs = list(pool.map(tables.ray_constants, [fit.cfg] * len(variants),
                             *zip(*(fit.axes[v] for v in variants)), pixels))
    gaps = [table_gap(fit, record, v, px, ref, program(v, px))
            for v, px, ref in zip(variants, pixels, refs)]
    return {'tables': max(g[0] for g in gaps),
            'tables_p90': max(g[1] for g in gaps)}


def numbers(fit, record, device):
    """Every number of the check for the program's record."""
    out = step_numbers(fit, record, reference_steps(fit, record, device))
    out.update(table_numbers(fit, record))
    return out


def load_limits(config_name):
    path = LIMITS / f'{config_name}.json'
    return json.loads(path.read_text())


def verdict(values, limits):
    """(correct, checks): each number beside its limit; a number whose
    limit is null was found not to separate the control from sound runs
    and is shown, not compared."""
    checks, ok = {}, True
    for name in NAMES + tuple(k for k in values if k not in NAMES):
        v = values.get(name)
        lim = limits.get(name, {}).get('limit')
        checks[name] = {'value': v, 'limit': lim}
        if lim is not None and not (v is not None and math.isfinite(v)
                                    and v <= lim):
            ok = False
    return ok, checks
