"""Recovery animations: movie comparison and rotating volume render.

PyTorch-package counterpart of examples/recovery_animation.py (the
animation cells of the reference's "Synthetic lightcurves 2.1" / "ALMA
lightcurves 1.1" notebooks): train a hotspot recovery on the card, then
write

* a synced true / recovered / difference movie GIF
  (visualization.animate_movies_synced), and
* a rotating-camera GIF of the recovered 3D emission with the
  bounding-cube wireframe and black-hole sphere overlays
  (visualization.VolumeVisualizer, composited on the card).

    python -m bhnerf_tpu_torch.examples.recovery_animation [--small] \\
        [--out DIR]

The full configuration traces 64x64 rays x 100 samples (n_fine 8192) and
fits 1000 steps through the fused kernels (fused=not small, as in the
reference) in chunks of 100; --small traces 16x16 x 32 (n_fine 2048) and
fits 200 plain steps. The GIFs are written where matplotlib imports; the
fit, the movie and every view's layers are computed either way.
"""
import argparse
import os

import numpy as np

from bhnerf_tpu_torch.tutorials import fused_launches, pyplot


def main(out_dir='example_outputs', small=False, device='cuda'):
    """Returns the final loss, the loss every 100 steps, the steps run,
    the fused kernels' launches in the fit and in the movie render, the
    movie's test loss, the recovered frames, the recovered volume and each
    view's layers (emission, BH shadow, wireframe, BH shade); with the
    predictor, the compacted ray constants (`crt`) and the frame times
    [hr] of the fit."""
    from bhnerf_tpu_torch import constants, emission, units
    from bhnerf_tpu_torch.geodesics import image_plane_geos
    from bhnerf_tpu_torch.models import NeRFPredictor, sample_3d_grid
    from bhnerf_tpu_torch.train import (LogFn, Optimizer, TrainStep,
                                        compact_raytracing_args,
                                        raytracing_args, total_movie_loss)
    from bhnerf_tpu_torch.visualization import (VolumeVisualizer,
                                                animate_movies_synced,
                                                layers_to_rgb)

    os.makedirs(out_dir, exist_ok=True)
    spin, inc = 0.2, np.deg2rad(60.0)
    fov_M = 16.0
    num = 16 if small else 64
    ngeo = 32 if small else 100
    nt = 12 if small else 64
    num_iters = 200 if small else 1000

    geos = image_plane_geos(spin, inc, (-fov_M / 2, fov_M / 2),
                            (-fov_M / 2, fov_M / 2), ngeo=ngeo,
                            num_alpha=num, num_beta=num,
                            n_fine=2048 if small else 8192, device=device)
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

    predictor = NeRFPredictor(scale=fov_M / 2, rmin=0.0, rmax=fov_M / 2,
                              z_width=2.0)
    rt = raytracing_args(geos, Omega, t_injection, t_frames[0],
                         device=device)
    crt = compact_raytracing_args(rt, predictor)
    train_step = TrainStep.image(t_frames, movie, predictor, dtype='full',
                                 fused=not small, device=device)
    optimizer = Optimizer({'num_iters': num_iters, 'lr_init': 1e-3,
                           'lr_final': 1e-5}, predictor, crt, device=device)
    losses = []
    record = LogFn(lambda opt: losses.append(float(opt.loss)),
                   log_period=100)
    before = fused_launches()
    optimizer.run(batchsize=min(6, nt), train_step=train_step,
                  raytracing_args=crt, log_fns=[record], verbose=not small,
                  scan_chunk=100)
    after_fit = fused_launches()

    # --- synced movie animation (true / recovered / difference) ----------
    movie_loss, frames = total_movie_loss(min(8, nt), optimizer.state,
                                          train_step, crt,
                                          return_frames=True)
    after_movie = fused_launches()
    launches = {'fit': tuple(a - b for a, b in zip(after_fit, before)),
                'movie': tuple(a - b for a, b in zip(after_movie,
                                                     after_fit))}

    # --- rotating volume render with cube + BH overlays ------------------
    vol = sample_3d_grid(predictor, optimizer.params, fov=fov_M,
                         resolution=48 if small else 64)
    res = (96, 96) if small else (256, 256)
    vis = VolumeVisualizer(resolution=res, fov=35.0,
                           samples=48 if small else 160, device=device)
    n_views = 6 if small else 24
    views = [vis.composite(vol, extent=fov_M / 2, azimuth=az,
                           zenith=np.pi / 3, sigma_scale=300.0,
                           bh_radius=1.0 + np.sqrt(1 - spin**2),
                           draw_cube=True)
             for az in np.linspace(0, 2 * np.pi, n_views, endpoint=False)]
    print(f'final loss {float(optimizer.loss):.6g}, movie loss '
          f'{movie_loss:.6g}; {n_views} views of {res[0]}x{res[1]} '
          f'composited; launches {launches}', flush=True)

    plt = pyplot()
    if plt is not None:
        fig, axes = plt.subplots(1, 3, figsize=(9, 3))
        anim = animate_movies_synced(
            [movie, frames, movie - frames], axes, fps=10,
            cmaps=['afmhot', 'afmhot', 'RdBu_r'],
            vmin=[0, 0, -movie.max() / 5],
            vmax=[movie.max(), movie.max(), movie.max() / 5],
            titles=['true', 'recovered', 'difference'],
            output=os.path.join(out_dir, 'recovery_movie.gif'))
        del anim
        renders = [layers_to_rgb(*layers) for layers in views]
        fig2, ax2 = plt.subplots(figsize=(4, 4))
        anim2 = animate_movies_synced(
            [np.stack(renders)], [ax2], fps=8, titles=['recovered volume'],
            vmin=[0.0], vmax=[1.0],
            output=os.path.join(out_dir, 'recovery_volume_rotation.gif'))
        del anim2
        plt.close('all')
        print('wrote', os.path.join(out_dir, 'recovery_movie.gif'), 'and',
              os.path.join(out_dir, 'recovery_volume_rotation.gif'))
    return dict(final_loss=float(optimizer.loss), losses=losses,
                steps=optimizer.state.step,
                launches=launches, movie_loss=movie_loss, frames=frames,
                movie=movie, views=views, volume=vol, predictor=predictor,
                crt=crt,
                t_frames=np.asarray(t_frames.value, np.float32))


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='example_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
