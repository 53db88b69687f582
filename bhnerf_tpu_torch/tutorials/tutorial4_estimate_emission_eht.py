"""Tutorial 4: estimate 3D emission from EHT observations.

PyTorch-package counterpart of tutorials/tutorial4_estimate_emission_eht.py
(the reference's "Tutorial4 - estimate 3D emission from EHT observations"
notebook): recover the hotspot from the complex visibilities of its
movie observed by the ngEHT array, rendered and fitted on the card.

    python -m bhnerf_tpu_torch.tutorials.tutorial4_estimate_emission_eht \\
        [--small] [--out DIR] [--operator dense|factored]

The fit keeps the reference's plain render (fused=False), its explicit
loop of 2000 steps of batch 6 at lr 1e-3 -> 1e-5 (--small: 200 at 16x16
rays) over 32 frames of the 4.0-15.5 UT window. The initial weights come
from a torch.Generator of seed 1 and the frame batches from one of
seed 0.
"""
import argparse
import os

import numpy as np

from bhnerf_tpu_torch.tutorials import array_path, fused_launches, pyplot

NUM_ITERS = 2000        # the reference's fit steps at full size


def main(out_dir='tutorial_outputs', small=False, operator='dense',
         device='cuda'):
    """Returns every step's loss (numpy), the recovered volume's psnr_3d,
    the count of visibilities and the fused kernels' launches in the
    fit."""
    import torch

    from bhnerf_tpu_torch import constants, emission, observation, units
    from bhnerf_tpu_torch import utils
    from bhnerf_tpu_torch.geodesics import image_plane_geos
    from bhnerf_tpu_torch.models import NeRFPredictor, sample_3d_grid
    from bhnerf_tpu_torch.train import (TrainState, TrainStep,
                                        make_optimizer, raytracing_args)

    os.makedirs(out_dir, exist_ok=True)
    spin, inc = 0.2, np.deg2rad(60.0)
    fov_M = 16.0
    num = 16 if small else 64
    ngeo = 32 if small else 64
    nt = 8 if small else 32
    num_iters = 200 if small else NUM_ITERS

    geos = image_plane_geos(spin, inc, (-fov_M / 2, fov_M / 2),
                            (-fov_M / 2, fov_M / 2), ngeo=ngeo,
                            num_alpha=num, num_beta=num, device=device)
    Omega = geos.keplerian_omega()
    r_isco = float(constants.isco_pro(spin))
    hotspot = emission.generate_hotspot(
        resolution=(64, 64, 64), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=1.1 * r_isco, std=0.7, r_isco=r_isco, fov=fov_M)
    t_frames = units.Quantity(np.linspace(4.0, 15.5, nt), 'hr')
    t_injection = -float(geos.r_o + fov_M / 4)
    movie = emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection,
        t_start_obs=t_frames[0], device=device).cpu().numpy()

    array = observation.load_txt(array_path('ngEHT.txt'))
    obs_empty = observation.empty_eht_obs(array, nt=nt, tint=30.0)
    fov_rad = float(fov_M * constants.GM_c2(constants.sgra_mass).value
                    / constants.sgra_distance.to('m').value)
    psize = fov_rad / num
    obs = observation.observe_same(movie, np.asarray(t_frames.value),
                                   psize, obs_empty, thermal_noise=True,
                                   seed=0)

    predictor = NeRFPredictor(scale=fov_M / 2, rmax=fov_M / 2, z_width=2.0)
    rt = raytracing_args(geos, Omega, t_injection, t_frames[0],
                         device=device)
    # operator='factored' is the production-npix form (npix-fold smaller
    # separable DFT, chisq-equal to dense; see observation.dft_factors)
    train_step = TrainStep.eht(t_frames, obs, fov_rad, num, predictor,
                               dtype='vis', operator=operator,
                               device=device)
    params = predictor.init_params(
        generator=torch.Generator().manual_seed(1), device=device)
    state = TrainState.create(params, make_optimizer(num_iters, lr_init=1e-3,
                                                     lr_final=1e-5))
    generator = torch.Generator().manual_seed(0)
    losses = []
    before = fused_launches()
    for i in range(num_iters):
        inds = train_step.args[0].sample(min(6, nt), generator)
        loss, state, _ = train_step(state, rt, inds)
        losses.append(loss.detach())
        if i % max(num_iters // 10, 1) == 0:
            print(f'iter {i}: loss {float(loss):.1f}', flush=True)
    launches = tuple(a - b for a, b in zip(fused_launches(), before))
    losses = torch.stack(losses).cpu().numpy()

    vol = sample_3d_grid(predictor, state.params, fov=fov_M, resolution=64)
    truth = hotspot.data.numpy()
    psnr_3d = float(utils.psnr(truth, vol))
    print(f'3D recovery from visibilities: PSNR {psnr_3d:.2f} dB')

    plt = pyplot()
    if plt is not None:
        fig, axes = plt.subplots(1, 3, figsize=(11, 3.5))
        axes[0].semilogy(losses)
        axes[0].set_title('chi2 loss')
        axes[1].imshow(truth.sum(-1), cmap='hot')
        axes[1].set_title('true (z-sum)')
        axes[2].imshow(vol.sum(-1), cmap='hot')
        axes[2].set_title('recovered')
        fig.savefig(os.path.join(out_dir, 'tutorial4_recovery.png'),
                    dpi=120)
        plt.close('all')
    print('wrote', out_dir)
    return dict(losses=losses, psnr_3d=psnr_3d, nvis=int(obs.mask.sum()),
                launches=launches)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='tutorial_outputs')
    p.add_argument('--small', action='store_true')
    p.add_argument('--operator', default='dense',
                   choices=['dense', 'factored'],
                   help='measurement operator: dense DFT matrix or the '
                        'separable factored form (use at npix >= 64)')
    args = p.parse_args()
    main(args.out, args.small, args.operator)
