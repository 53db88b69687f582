"""ALMA polarized-lightcurve workflow.

PyTorch counterpart of `bhnerf_tpu/alma.py`: data preprocessing for the
Apr-11-2017 Sgr A* flare, the polarized image-plane model (Keplerian flow
+ fluid-frame B field + parallel transport), sub-pixel ray ensembles of
ray constants (:21-161), and the chi-square of trained checkpoints and of
a grid of them (:164-247). The model is once-per-configuration host work
in numpy float64 with the geodesics from the host tracer; the checkpoints
are the port's `torch.save` files, rendered on the device of the ray
constants.
"""
from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np

from bhnerf_tpu_torch import constants, emission, tracing, units
from bhnerf_tpu_torch.geodesics import (Geodesics, image_plane_geos,
                                        subpixel_jittered_axes,
                                        trace_geodesics)
from bhnerf_tpu_torch.ops import gr
from bhnerf_tpu_torch.train import step as step_lib

# the tracer's sizes when the model block does not set them: samples a ray
# and fine integration steps
TRACE_DEFAULTS = {'ngeo': 100, 'n_fine': 8192}


def trace_sizes(params):
    """The tracer's sizes (ngeo, n_fine) of a model block: its own where
    it sets them, else TRACE_DEFAULTS."""
    return {k: params.get(k, v) for k, v in TRACE_DEFAULTS.items()}


def _read_csv(path):
    """A comma-separated file with a header line whose first column is a
    row index: (column names, float64 array (rows, columns)) without the
    index column; empty fields become NaN."""
    with open(path, newline='') as f:
        rows = [row for row in csv.reader(f) if row]
    names = [h.strip() for h in rows[0][1:]]
    data = np.array([[float(x) if x.strip() else np.nan for x in row[1:]]
                     for row in rows[1:]], np.float64)
    return names, data.reshape(-1, len(names))


def preprocess_data(data_path, window_size, I_hs_mean, P_sha, chi_sha,
                    de_rot_angle, t_start=9.33, t_end=11.05):
    """Load + window-average the ALMA lightcurve CSV (an index column, then
    named columns among them time, Q and U),
    subtract the constant shadow polarization, de-rotate Faraday rotation,
    prepend the intensity prior (reference alma.py:21-43).

    The rows inside [t_start, t_end] are averaged over consecutive windows
    of `window_size` rows that end at every window_size-th row (the first
    row belongs to no window, as in the reference's rolling mean sampled
    at every window_size-th position); a window that holds a missing value
    is dropped, and so is one that lies 160 s or more after the window
    kept before it (an average across a scan gap). Returns (target
    (nt, 3) [I prior, Q, U], t_frames in hours)."""
    names, data = _read_csv(data_path)
    missing = [n for n in ('time', 'Q', 'U') if n not in names]
    if missing:
        raise ValueError(f'{data_path}: no column {missing} among {names}')
    time = data[:, names.index('time')]
    loops = data[(time >= t_start) & (time <= t_end)]
    ends = np.arange(window_size, len(loops), window_size)
    means = np.array([loops[e - window_size + 1:e + 1].mean(axis=0)
                      for e in ends]).reshape(-1, len(names))
    means = means[~np.isnan(means).any(axis=1)]
    # drop points averaged across scan gaps
    t_mean = means[:, names.index('time')]
    means = means[np.diff(t_mean, prepend=t_mean[:1]) < 160 / 3600]
    t_frames = units.Quantity(means[:, names.index('time')], 'hr')

    qu_sha = P_sha * np.array([np.cos(2 * np.deg2rad(chi_sha)),
                               np.sin(2 * np.deg2rad(chi_sha))])
    qu = means[:, [names.index('Q'), names.index('U')]]
    target = emission.rotate_evpa(qu - qu_sha, np.deg2rad(de_rot_angle),
                                  axis=1)
    target = np.pad(target, ([0, 0], [1, 0]), constant_values=I_hs_mean)
    return target, t_frames


def image_plane_model(inc, spin, params, rot_angle=0.0,
                      randomize_subpixel_rays=False, rng=None,
                      backend='cpu', mesh=None, device='cuda'):
    """Geodesics + Keplerian velocity + normalized fluid-frame B field +
    polarized transport factors (reference alma.py:46-65). params is the
    model block of the fit configuration; its optional keys ngeo and
    n_fine size the trace (TRACE_DEFAULTS when absent). rng:
    np.random.Generator for the sub-pixel jitter. backend='device' traces in float32 on `device`
    (geodesics.trace_geodesics), over the ranks of `mesh` when one is
    given; the physics stays host float64, on every rank."""
    fov_M = params['fov_M']
    geos = image_plane_geos(
        spin, inc, num_alpha=params['num_alpha'],
        num_beta=params['num_beta'],
        alpha_range=[-fov_M / 2, fov_M / 2],
        beta_range=[-fov_M / 2, fov_M / 2],
        **trace_sizes(params),
        randomize_subpixel_rays=randomize_subpixel_rays, rng=rng,
        backend=backend, mesh=mesh, device=device)
    return _model_physics(geos, params, rot_angle)


@tracing.traced('bhnerf.precompute.ray_constants')
def _model_physics(geos, params, rot_angle):
    """Velocity + B-field + transport factors for an already-traced
    image plane (the non-trace half of image_plane_model). Returns
    (geos, Omega, J) with J (3, na, nb, ngeo) float64 and NaN-free."""
    rot_sign = {'cw': -1, 'ccw': 1}
    fov_M, z_width = params['fov_M'], params['z_width']
    rmin = (float(constants.isco_pro(geos.spin))
            if params['rmin'] == 'ISCO' else params['rmin'])
    rmax = fov_M / 2

    Omega = geos.keplerian_omega(direction=rot_sign[params['Omega_dir']],
                                 frac=params.get('Omega_frac', 1.0))
    umu = gr.azimuthal_velocity_vector(geos, Omega)
    g = gr.doppler_factor(geos, umu)

    # B field magnitude-normalized over the supervised domain
    b = gr.magnetic_field_fluid_frame(geos, umu, **params['b_consts'])
    domain = ((np.abs(geos.z) < z_width) & (geos.r > rmin)
              & (geos.r < rmax))
    b_mean = np.nanmean(np.sqrt(np.sum(b[domain] ** 2, axis=-1)))
    b = b / b_mean

    J = np.nan_to_num(gr.parallel_transport(
        geos, umu, g, b, Q_frac=params['Q_frac'], V_frac=0), nan=0.0)
    return geos, Omega, emission.rotate_evpa(J, rot_angle)


def _trace_subpixel_ensemble(inc, spin, params, num_variants, rng,
                             backend, mesh=None, device='cuda'):
    """Trace all sub-pixel-ray variants in one trace_geodesics call
    (reference alma.py:98-128): the V jittered screen grids stacked as
    (V, na, nb), one kernel launch on the card instead of V, then split
    back into per-variant Geodesics. The jitter is drawn by
    subpixel_jittered_axes variant after variant, the alpha axis before
    the beta axis, so a seed gives the grids of the per-variant
    image_plane_geos loop and of the JAX package. Under a `mesh` each rank
    launches once, on its block of every variant's rays."""
    num_alpha, num_beta = params['num_alpha'], params['num_beta']
    fov_M = params['fov_M']
    rng = np.random.default_rng() if rng is None else rng
    ranges = ((-fov_M / 2, fov_M / 2), (-fov_M / 2, fov_M / 2))
    alphas, betas = [], []
    for _ in range(num_variants):
        a1, b1 = subpixel_jittered_axes(*ranges, num_alpha, num_beta, rng)
        a, b = np.meshgrid(a1, b1, indexing='ij')
        alphas.append(a)
        betas.append(b)
    geos_all = trace_geodesics(
        np.stack(alphas), np.stack(betas), spin, inc,
        **trace_sizes(params),
        backend=backend, mesh=mesh, device=device)
    return [dataclasses.replace(
        geos_all, **{f: getattr(geos_all, f)[v] for f in Geodesics._FIELDS})
        for v in range(num_variants)]


def get_raytracing_args(inc, spin, params, stokes=('I', 'Q', 'U'),
                        rot_angle=0.0, num_subpixel_rays=1, rng=None,
                        backend='cpu', mesh=None, device='cuda'):
    """Sub-pixel ray ensemble of RayTracingArgs on `device` (reference
    alma.py:131-161): num_subpixel_rays tables, each with its own
    sub-pixel jitter drawn from `rng` (one regular grid when
    num_subpixel_rays is 1). backend='cpu' traces each table on the host
    in float64; backend='device' traces in float32 on `device`, the whole
    ensemble in one launch (_trace_subpixel_ensemble), or one launch a
    rank over the ranks of `mesh` (reference alma.py:131-152). The host
    physics runs on every rank on the whole table."""
    J_inds = [['I', 'Q', 'U'].index(s) for s in stokes]
    randomize = num_subpixel_rays > 1
    geos_list = (_trace_subpixel_ensemble(inc, spin, params,
                                          num_subpixel_rays, rng, backend,
                                          mesh=mesh, device=device)
                 if backend == 'device' and randomize else None)
    args_list = []
    for i in range(num_subpixel_rays):
        if geos_list is None:
            geos, Omega, J = image_plane_model(
                inc, spin, params, rot_angle, randomize, rng=rng,
                backend=backend, mesh=mesh, device=device)
        else:
            geos, Omega, J = _model_physics(geos_list[i], params, rot_angle)
        t_injection = -float(geos.r_o + params['fov_M'] / 4)
        args_list.append(step_lib.raytracing_args(
            geos, Omega, t_injection,
            units.Quantity(params['t_start_obs'], 'hr'), J[J_inds],
            device=device))
    return args_list


def image_plane_checkpoint(raytracing_args, checkpoint_dir, t, rmin=0.0,
                           rmax=np.inf, batchsize=20):
    """The image-plane movie of the latest checkpoint under
    `checkpoint_dir` at times `t` (reference alma.py:164-190). The
    predictor is the checkpoint's own (its yaml), with its domain narrowed
    to [rmin, rmax]; the movie is the test-mode mean over every variant of
    the ray-constant ensemble, rendered through the fused kernels on the
    device of the ray constants. Returns (nt, nstokes, na, nb) numpy."""
    from bhnerf_tpu_torch.models.fields import NeRFPredictor
    from bhnerf_tpu_torch.train import (TrainState, TrainStep, make_optimizer,
                                        restore_params, total_movie_loss)

    predictor = NeRFPredictor.from_yml(checkpoint_dir)
    predictor = dataclasses.replace(
        predictor, rmax=min(rmax, predictor.rmax),
        rmin=max(rmin, predictor.rmin))
    rt_list = (list(raytracing_args)
               if isinstance(raytracing_args, (list, tuple))
               else [raytracing_args])
    device = rt_list[0].coords.device
    params = restore_params(checkpoint_dir,
                            predictor.init_params(device=device))
    state = TrainState.create(params, make_optimizer(10))
    num_stokes = rt_list[0].num_stokes
    train_step = TrainStep.image(t, np.zeros((len(t), num_stokes)),
                                 predictor, dtype='lc', fused=True,
                                 device=device)
    _, image_plane = total_movie_loss(batchsize, state, train_step, rt_list,
                                      return_frames=True)
    return image_plane


def chi2_lightcurves(raytracing_args, checkpoint_dir, t, data, sigma=1.0,
                     rmin=0.0, rmax=np.inf, batchsize=20):
    """Lightcurve chi^2 per frame of a trained checkpoint against `data`
    (nt, nstokes) (reference alma.py:193-200)."""
    image_plane = image_plane_checkpoint(raytracing_args, checkpoint_dir,
                                         t, rmin, rmax, batchsize)
    return np.sum(((image_plane.sum(axis=(-1, -2)) - np.asarray(data))
                   / sigma) ** 2) / len(t)


def chi2_df(inclinations, spins, seeds, params, checkpoint_fmt, t, data,
            stokes=('I', 'Q', 'U'), sigma=1.0, rot_angle=0.0,
            num_subpixel_rays=1, checkpoint_name='checkpoint_50000',
            backend='cpu', mesh=None, device='cuda'):
    """chi^2(inclination or spin x seed) as a pandas DataFrame over a grid
    of checkpoint directories checkpoint_fmt.format(index, seed)
    (reference alma.py:203-247); a cell whose directory lacks
    `checkpoint_name` stays NaN. As in the reference, a filled cell is the
    chi^2 of its directory's latest checkpoint (image_plane_checkpoint),
    which is `checkpoint_name` only if no later one was saved. The ray
    constants are traced on the host
    once per grid point, on the host in float64 (backend='cpu') or in float32
    on `device` (backend='device'), and live on `device`. `mesh` shards
    each trace's rays over its ranks (backend='device' only; reference
    alma.py:204-239); every rank then scores every cell."""
    import pandas as pd

    if backend not in ('cpu', 'device'):
        raise ValueError(f"backend must be 'cpu' or 'device', got "
                         f'{backend!r}')
    if mesh is not None and backend != 'device':
        raise ValueError("mesh-sharded tracing requires backend='device' "
                         '(the host float64 trace is one process)')
    inclinations = np.atleast_1d(inclinations)
    spins = np.atleast_1d(spins)
    if len(inclinations) == 1 and len(spins) > 1:
        indices, index_name = spins, 'spin'
        inclinations = np.full(len(spins), float(inclinations[0]))
    elif len(inclinations) >= 1 and len(spins) == 1:
        indices, index_name = inclinations, 'inc'
        spins = np.full(len(inclinations), float(spins[0]))
    else:
        raise ValueError('only 1D grids (inc or spin) are supported')

    inc_prev = spin_prev = np.nan
    rt_args = None
    data_fit = np.full((len(indices), len(seeds)), np.nan)
    for i, (inc, spin) in enumerate(zip(inclinations, spins)):
        for j, seed in enumerate(seeds):
            checkpoint_dir = checkpoint_fmt.format(indices[i], seed)
            if not os.path.exists(os.path.join(checkpoint_dir,
                                               checkpoint_name)):
                continue
            if inc_prev != inc or spin_prev != spin:
                rt_args = get_raytracing_args(
                    np.deg2rad(inc), spin, params, stokes, rot_angle,
                    num_subpixel_rays, backend=backend, mesh=mesh,
                    device=device)
                inc_prev, spin_prev = inc, spin
            data_fit[i, j] = chi2_lightcurves(rt_args, checkpoint_dir, t,
                                              data, sigma)

    df = pd.DataFrame(data_fit, index=indices,
                      columns=[f'seed {s}' for s in seeds])
    df.index.name = index_name
    return df
