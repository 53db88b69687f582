"""Tutorial 3: estimate 3D emission from image-plane measurements.

PyTorch-package counterpart of
tutorials/tutorial3_estimate_emission_image_plane.py (the reference's
"Tutorial3 - estimate 3D emission from image plane" notebook):
closed-loop recovery of an orbiting hotspot from its movie, rendered
and fitted on the card.

    python -m bhnerf_tpu_torch.tutorials.tutorial3_estimate_emission_image_plane \\
        [--small] [--out DIR]

The fit keeps the reference's plain render (TrainStep.image's default
fused=False), its 1000 steps of batch 6 at lr 1e-3 -> 1e-5 (--small: 200
steps at 16x16 rays) and its checkpoint under
<out>/tutorial3_checkpoint, which tutorial 5 renders. A checkpoint that
is there already is resumed, as the reference's Optimizer does.
"""
import argparse
import os

import numpy as np

from bhnerf_tpu_torch.tutorials import fused_launches, pyplot


def main(out_dir='tutorial_outputs', small=False, device='cuda'):
    """Returns the final loss, the loss every num_iters / 20 steps, the
    recovered volume's psnr_3d and correlation against the hotspot, the
    steps run, the compacted sample count and the fused kernels' launches
    in the fit."""
    from bhnerf_tpu_torch import constants, emission, units, utils
    from bhnerf_tpu_torch.geodesics import image_plane_geos
    from bhnerf_tpu_torch.models import NeRFPredictor, sample_3d_grid
    from bhnerf_tpu_torch.train import (LogFn, Optimizer, TrainStep,
                                        compact_raytracing_args,
                                        raytracing_args)

    os.makedirs(out_dir, exist_ok=True)
    spin, inc = 0.2, np.deg2rad(60.0)
    fov_M = 16.0
    num = 16 if small else 64
    ngeo = 32 if small else 100
    nt = 16 if small else 64
    num_iters = 200 if small else 1000

    geos = image_plane_geos(spin, inc, (-fov_M / 2, fov_M / 2),
                            (-fov_M / 2, fov_M / 2), ngeo=ngeo,
                            num_alpha=num, num_beta=num, device=device)
    Omega = geos.keplerian_omega()
    r_isco = float(constants.isco_pro(spin))
    hotspot = emission.generate_hotspot(
        resolution=(64, 64, 64), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=1.1 * r_isco, std=0.7, r_isco=r_isco, fov=fov_M)
    t_frames = units.Quantity(np.linspace(0.0, 1.0, nt), 'hr')
    t_injection = -float(geos.r_o + fov_M / 4)
    movie = emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection,
        device=device).cpu().numpy()

    # recovery
    predictor = NeRFPredictor(scale=fov_M / 2, rmin=0.0, rmax=fov_M / 2,
                              z_width=2.0)
    rt = raytracing_args(geos, Omega, t_injection, t_frames[0],
                         device=device)
    rt = compact_raytracing_args(rt, predictor)
    train_step = TrainStep.image(t_frames, movie, predictor, dtype='full',
                                 device=device)
    checkpoint_dir = os.path.join(out_dir, 'tutorial3_checkpoint')
    optimizer = Optimizer({'num_iters': num_iters, 'lr_init': 1e-3,
                           'lr_final': 1e-5}, predictor, rt,
                          checkpoint_dir=checkpoint_dir, device=device)
    losses = []
    record = LogFn(lambda opt: losses.append(float(opt.loss)),
                   log_period=max(num_iters // 20, 1))
    before = fused_launches()
    optimizer.run(batchsize=min(6, nt), train_step=train_step,
                  raytracing_args=rt, log_fns=[record])
    launches = tuple(a - b for a, b in zip(fused_launches(), before))
    final_loss = float(optimizer.loss)
    print('final loss:', final_loss)

    # compare recovered volume to truth
    vol = sample_3d_grid(predictor, optimizer.params, fov=fov_M,
                         resolution=64)
    truth = hotspot.data.numpy()
    psnr_3d = float(utils.psnr(truth, vol))
    corr = float(np.corrcoef(vol.ravel(), truth.ravel())[0, 1])
    print(f'3D recovery: PSNR {psnr_3d:.2f} dB, corr {corr:.3f}')

    plt = pyplot()
    if plt is not None:
        fig, axes = plt.subplots(1, 2, figsize=(8, 4))
        axes[0].imshow(truth.sum(-1), cmap='hot')
        axes[0].set_title('true emission (z-sum)')
        axes[1].imshow(vol.sum(-1), cmap='hot')
        axes[1].set_title('recovered')
        for ax in axes:
            ax.axis('off')
        fig.savefig(os.path.join(out_dir, 'tutorial3_recovery.png'),
                    dpi=120)
        plt.close('all')
    print('wrote', out_dir)
    return dict(final_loss=final_loss, losses=losses, psnr_3d=psnr_3d,
                corr=corr, steps=optimizer.state.step,
                n=rt.coords.shape[1], launches=launches,
                checkpoint_dir=checkpoint_dir)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='tutorial_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
