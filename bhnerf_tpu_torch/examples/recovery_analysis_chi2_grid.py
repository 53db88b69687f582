"""Recovery analysis: chi^2(inclination) over a grid of trained fits.

PyTorch-package counterpart of examples/recovery_analysis_chi2_grid.py
(the reference's "Synthetic lightcurves 2/2.1" notebooks, cells 8-9):
render the I, Q and U lightcurves of a hotspot at a true inclination on
the card, fit recoveries over an inclination x seed grid, score every
checkpoint with alma.chi2_df, and check that chi^2 is least at the truth.

    python -m bhnerf_tpu_torch.examples.recovery_analysis_chi2_grid \\
        [--small] [--device-geos]

--device-geos traces each grid point's tables with the float32 tracer
kernel on the card (one launch a grid point's ensemble) instead of the
float64 host trace. The fits run the predictor's plain render
(predict_emission, fused=False), as the reference's run its XLA path; the
checkpoints are scored through the fused kernels (alma.chi2_df). The full
configuration asserts that chi^2 is least at the true inclination, the
small one only that every chi^2 is finite. The plot is drawn where
matplotlib imports.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

TRUE_INC = 60.0
SPIN = 0.0
# the reference's two configurations (:31-48)
CONFIGS = {
    'small': dict(inclinations=[45.0, 60.0, 75.0], seeds=[1],
                  num_iters=200, num_subpixel_rays=2, npix=16, nt=24),
    'full': dict(inclinations=[40.0, 50.0, 60.0, 70.0, 80.0], seeds=[1, 2],
                 num_iters=2000, num_subpixel_rays=4, npix=32, nt=48),
}


def main(out_dir='example_outputs', small=False, device_geos=False,
         device='cuda'):
    from bhnerf_tpu_torch import alma, constants, emission, units
    from bhnerf_tpu_torch.models.fields import NeRFPredictor
    from bhnerf_tpu_torch.train import Optimizer, TrainStep

    t_start = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    cfg = CONFIGS['small' if small else 'full']
    inclinations, seeds = cfg['inclinations'], cfg['seeds']
    num_iters = cfg['num_iters']
    num_subpixel_rays = cfg['num_subpixel_rays']
    backend = 'device' if device_geos else 'cpu'
    params = {
        'spin': SPIN, 'fov_M': 16.0, 'z_width': 2.0, 'rmin': 'ISCO',
        'Q_frac': 0.85, 'b_consts': {'arad': 0, 'avert': 1, 'ator': 0},
        'Omega_dir': 'cw', 'Omega_frac': 1.0,
        'num_alpha': cfg['npix'], 'num_beta': cfg['npix'],
        't_start_obs': 9.4,
    }
    t_frames = units.Quantity(np.linspace(9.4, 10.2, cfg['nt']), 'hr')

    # ---- synthetic polarized lightcurve at the TRUE inclination ---------
    print(f'# generating synthetic Q/U lightcurves at inc={TRUE_INC}')
    geos, Omega, J = alma.image_plane_model(np.deg2rad(TRUE_INC), SPIN,
                                            params)
    t_injection = -float(geos.r_o + params['fov_M'] / 4)
    rmin = float(constants.isco_pro(SPIN))
    hotspot = emission.generate_hotspot(
        resolution=(32, 32, 32), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=1.2 * rmin, std=0.6, r_isco=rmin, fov=params['fov_M'])
    movie = emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection, J=J,
        t_start_obs=units.Quantity(params['t_start_obs'], 'hr'),
        device=device).cpu().numpy()
    target = movie.sum(axis=(-1, -2))        # (nt, 3) I/Q/U lightcurves
    sigma = np.array([0.05, 0.01, 0.01]) * max(target[:, 0].max(), 1e-12)

    # ---- fit recoveries over the inclination x seed grid ----------------
    ckpt_fmt = os.path.join(out_dir, 'chi2_grid', 'inc{}', 'seed{}')
    ckpt_name = f'checkpoint_{num_iters}'
    for inc in inclinations:
        rt_list = alma.get_raytracing_args(
            np.deg2rad(inc), SPIN, params, stokes=('I', 'Q', 'U'),
            num_subpixel_rays=num_subpixel_rays,
            rng=np.random.default_rng(0), backend=backend, device=device)
        for seed in seeds:
            ckpt_dir = ckpt_fmt.format(inc, seed)
            if os.path.exists(os.path.join(ckpt_dir, ckpt_name)):
                print(f'# inc={inc} seed={seed}: checkpoint exists, skip')
                continue
            print(f'# fitting inc={inc} seed={seed}')
            predictor = NeRFPredictor(
                scale=params['fov_M'] / 2, rmin=rmin,
                rmax=params['fov_M'] / 2, z_width=params['z_width'],
                net_depth=3, net_width=32)
            train_step = TrainStep.image(t_frames, target, predictor,
                                         sigma=sigma, dtype='lc',
                                         device=device)
            optimizer = Optimizer(
                {'num_iters': num_iters, 'lr_init': 5e-3,
                 'lr_final': 1e-4, 'seed': seed}, predictor, rt_list,
                checkpoint_dir=ckpt_dir, device=device)
            optimizer.run(batchsize=6, train_step=train_step,
                          raytracing_args=rt_list, verbose=not small)

    # ---- chi^2 grid scan -------------------------------------------------
    print('# scoring the checkpoint grid with alma.chi2_df')
    df = alma.chi2_df(inclinations, SPIN, seeds, params, ckpt_fmt,
                      t_frames, target, sigma=sigma,
                      num_subpixel_rays=num_subpixel_rays,
                      checkpoint_name=ckpt_name, backend=backend,
                      device=device)
    print(df)
    best = df.mean(axis=1).idxmin()
    print(f'# chi^2 minimized at inc={best} (true {TRUE_INC}), '
          f'{time.perf_counter() - t_start:.1f} s from the start')

    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
    except ImportError:
        print('# matplotlib is not installed: no plot')
    else:
        fig, ax = plt.subplots(figsize=(5, 3.5))
        ax.plot(df.index, df.mean(axis=1), 'o-', label='mean over seeds')
        ax.axvline(TRUE_INC, color='k', ls='--', label='true inclination')
        ax.set_xlabel('inclination [deg]')
        ax.set_ylabel(r'$\chi^2$')
        ax.legend()
        fig.tight_layout()
        path = os.path.join(out_dir, 'chi2_inclination_scan.png')
        fig.savefig(path, dpi=120)
        print('wrote', path)
    if small:
        # the 16x16 / 200-iteration configuration does not reliably
        # discriminate inclinations (the full one does, and asserts it):
        # here only check that the scan produced finite chi^2 values
        assert np.isfinite(df.values).all(), df
    else:
        assert best == TRUE_INC, (best, TRUE_INC)
    return df


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='example_outputs')
    p.add_argument('--small', action='store_true')
    p.add_argument('--device-geos', action='store_true')
    args = p.parse_args()
    main(args.out, args.small, args.device_geos)
