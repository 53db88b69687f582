"""ALMA polarized-lightcurve workflow.

PyTorch counterpart of `bhnerf_tpu/alma.py` (:21-161): data preprocessing
for the Apr-11-2017 Sgr A* flare, the polarized image-plane model
(Keplerian flow + fluid-frame B field + parallel transport) and sub-pixel
ray ensembles of ray constants. Everything here is once-per-configuration
host work in numpy float64; the geodesics come from the host tracer. The
chi-square scans over checkpoint grids are not ported yet (they need
checkpoints).
"""
from __future__ import annotations

import csv

import numpy as np

from bhnerf_tpu_torch import constants, emission, units
from bhnerf_tpu_torch.geodesics import image_plane_geos
from bhnerf_tpu_torch.ops import gr
from bhnerf_tpu_torch.train import step as step_lib


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
                      randomize_subpixel_rays=False, rng=None):
    """Geodesics + Keplerian velocity + normalized fluid-frame B field +
    polarized transport factors (reference alma.py:46-65). params is the
    model block of the fit configuration; its optional keys ngeo and
    n_fine size the host trace (100 samples a ray and 8192 fine steps
    when absent, the tracer's defaults). rng: np.random.Generator for the
    sub-pixel jitter."""
    fov_M = params['fov_M']
    geos = image_plane_geos(
        spin, inc, num_alpha=params['num_alpha'],
        num_beta=params['num_beta'],
        alpha_range=[-fov_M / 2, fov_M / 2],
        beta_range=[-fov_M / 2, fov_M / 2],
        ngeo=params.get('ngeo', 100), n_fine=params.get('n_fine', 8192),
        randomize_subpixel_rays=randomize_subpixel_rays, rng=rng)
    return _model_physics(geos, params, rot_angle)


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


def get_raytracing_args(inc, spin, params, stokes=('I', 'Q', 'U'),
                        rot_angle=0.0, num_subpixel_rays=1, rng=None,
                        device='cuda'):
    """Sub-pixel ray ensemble of RayTracingArgs on `device` (reference
    alma.py:131-161): num_subpixel_rays tables, each traced on the host
    with its own sub-pixel jitter drawn from `rng` (one regular grid when
    num_subpixel_rays is 1)."""
    J_inds = [['I', 'Q', 'U'].index(s) for s in stokes]
    randomize = num_subpixel_rays > 1
    args_list = []
    for _ in range(num_subpixel_rays):
        geos, Omega, J = image_plane_model(inc, spin, params, rot_angle,
                                           randomize, rng=rng)
        t_injection = -float(geos.r_o + params['fov_M'] / 4)
        args_list.append(step_lib.raytracing_args(
            geos, Omega, t_injection,
            units.Quantity(params['t_start_obs'], 'hr'), J[J_inds],
            device=device))
    return args_list
