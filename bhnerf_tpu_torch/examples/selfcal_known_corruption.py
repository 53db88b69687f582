"""Self-calibration against known station corruption.

PyTorch-package counterpart of examples/selfcal_known_corruption.py:
observe_same records the station gains, D-terms and feed angles it drew
(`obs.applied_jones`), so an experiment can calibrate the corruption
back out and fit as if the array were ideal.

1. render an orbiting-hotspot movie on the card and observe it with the
   EHT2017 array, with station gain errors, D-term leakage and
   uncalibrated field rotation (`observe_same(station_noise=True,
   dterm_noise=True, frcal=False)`);
2. read the truth tables off the observation (`obs.applied_jones`);
3. calibrate fully (`obs.calibrate()`) and partially
   (`calibrate(gains=False)`: known D-terms and feed rotation only) and
   compare visibility residuals: the full calibration must be exact
   (median relative error below 1e-9);
4. fit the emission on the corrupted and on the calibrated data on the
   card and compare the chi^2.

    python -m bhnerf_tpu_torch.examples.selfcal_known_corruption \\
        [--small] [--out DIR]

The fits keep the reference's plain render (fused=False); their initial
weights come from a torch.Generator of seed 1 and their frame batches
from one of seed 0.
"""
import argparse
import os

import numpy as np

from bhnerf_tpu_torch.tutorials import array_path, fused_launches, pyplot


def main(out_dir='example_outputs', small=False, device='cuda'):
    """Returns the median relative visibility errors of the corrupted,
    the D-term-and-feed calibrated and the fully calibrated observation,
    each fit's losses (numpy) and the fused kernels' launches in the
    fits."""
    import torch

    from bhnerf_tpu_torch import constants, emission, observation, units
    from bhnerf_tpu_torch.geodesics import image_plane_geos
    from bhnerf_tpu_torch.models import NeRFPredictor
    from bhnerf_tpu_torch.train import (TrainState, TrainStep,
                                        make_optimizer, raytracing_args)

    os.makedirs(out_dir, exist_ok=True)
    spin, inc = 0.2, np.deg2rad(60.0)
    fov_M = 16.0
    num = 16 if small else 32
    ngeo = 24 if small else 64
    nt = 8 if small else 16
    num_iters = 150 if small else 1000

    geos = image_plane_geos(spin, inc, (-fov_M / 2, fov_M / 2),
                            (-fov_M / 2, fov_M / 2), ngeo=ngeo,
                            num_alpha=num, num_beta=num, device=device)
    Omega = geos.keplerian_omega()
    r_isco = float(constants.isco_pro(spin))
    hotspot = emission.generate_hotspot(
        resolution=(32, 32, 32), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=1.2 * r_isco, std=0.7, r_isco=r_isco, fov=fov_M)
    t_frames = units.Quantity(np.linspace(4.0, 15.5, nt), 'hr')
    t_injection = -float(geos.r_o + fov_M / 4)
    movie_I = emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection,
        t_start_obs=t_frames[0], device=device).cpu().numpy()
    # full-Stokes container (30% linear polarization): D-term leakage
    # moves power between RR/LL and RL/LR, so an I-only observation would
    # truncate the leaked cross-hands and no calibration could be exact
    movie = np.stack([movie_I, 0.3 * movie_I, 0.1 * movie_I,
                      np.zeros_like(movie_I)], axis=1)

    array = observation.load_txt(array_path('EHT2017.txt'))
    obs_empty = observation.empty_eht_obs(array, nt=nt, tint=60.0)
    fov_rad = float(fov_M * constants.GM_c2(constants.sgra_mass).value
                    / constants.sgra_distance.to('m').value)
    psize = fov_rad / num

    # ideal (thermal-noise-free) reference + fully corrupted observation
    obs_ideal = observation.observe_same(
        movie, np.asarray(t_frames.value), psize, obs_empty,
        thermal_noise=False)
    obs_corr = observation.observe_same(
        movie, np.asarray(t_frames.value), psize, obs_empty,
        thermal_noise=False, station_noise=True, dterm_noise=True,
        frcal=False, seed=7)
    aj = obs_corr.applied_jones
    print(f'recorded corruption: gains {aj.g_R.shape}, D-terms '
          f'{aj.d_R.shape}, field angles '
          f'{"yes" if aj.phi is not None else "no"}')

    m = obs_corr.mask
    ref = obs_ideal.vis[m]

    def vis_err(o):
        return float(np.nanmedian(np.abs(o.vis[m] - ref)
                                  / (np.abs(ref) + 1e-9)))

    obs_cal = obs_corr.calibrate()                      # full truth tables
    obs_part = obs_corr.calibrate(gains=False)          # D-terms + feeds
    errors = {'corrupted': vis_err(obs_corr), 'partial': vis_err(obs_part),
              'calibrated': vis_err(obs_cal)}
    print(f'median |vis error| / |vis|: corrupted {errors["corrupted"]:.3f}'
          f' -> D+feed calibrated {errors["partial"]:.3f}'
          f' -> fully calibrated {errors["calibrated"]:.2e}')
    if not errors['calibrated'] < 1e-9:
        raise AssertionError('truth-table calibration must be exact')

    # fit the emission on corrupted vs calibrated data
    predictor = NeRFPredictor(scale=fov_M / 2, rmin=r_isco,
                              rmax=fov_M / 2, z_width=2.0,
                              net_depth=2, net_width=32)
    rt = raytracing_args(geos, Omega, t_injection, t_frames[0],
                         device=device)
    chi2 = {}
    before = fused_launches()
    for name, o in (('corrupted', obs_corr), ('calibrated', obs_cal)):
        ts = TrainStep.eht(t_frames, o, fov_rad, num, predictor,
                           dtype='vis', device=device)
        params = predictor.init_params(
            generator=torch.Generator().manual_seed(1), device=device)
        state = TrainState.create(params,
                                  make_optimizer(num_iters, lr_init=1e-3))
        generator = torch.Generator().manual_seed(0)
        losses = []
        for _ in range(num_iters):
            inds = ts.args[0].sample(min(6, nt), generator)
            loss, state, _ = ts(state, rt, inds)
            losses.append(loss.detach())
        chi2[name] = torch.stack(losses).cpu().numpy()
        print(f'{name}: final loss {chi2[name][-1]:.1f}')
    launches = tuple(a - b for a, b in zip(fused_launches(), before))

    plt = pyplot()
    if plt is not None:
        fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
        axes[0].hist(np.abs(obs_corr.vis[m] - ref).ravel(), bins=40,
                     alpha=0.6, label='corrupted')
        axes[0].hist(np.abs(obs_cal.vis[m] - ref).ravel(), bins=40,
                     alpha=0.6, label='calibrated')
        axes[0].set_yscale('log')
        axes[0].set_xlabel('|vis residual| [Jy]')
        axes[0].legend()
        for name, losses in chi2.items():
            axes[1].semilogy(losses, label=name)
        axes[1].set_xlabel('iteration')
        axes[1].set_ylabel('vis chi^2')
        axes[1].legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, 'selfcal_known_corruption.png'),
                    dpi=120)
        plt.close('all')
    print('wrote', out_dir)
    return dict(vis_err=errors, chi2=chi2, launches=launches)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='example_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
