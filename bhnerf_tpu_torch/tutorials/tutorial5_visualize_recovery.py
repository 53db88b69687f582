"""Tutorial 5: visualize recovery results.

PyTorch-package counterpart of tutorials/tutorial5_visualize_recovery.py
(the reference's "Tutorial5 - visualize recovery results" notebook):
render the recovered 3D emission volume of tutorial 3's checkpoint with
the flat-space pinhole-camera VolumeVisualizer, whose alpha compositing
runs on the card, from three azimuths with the bounding-cube wireframe
and the black-hole sphere.

    python -m bhnerf_tpu_torch.tutorials.tutorial5_visualize_recovery \\
        [--small] [--out DIR]

Run after tutorial 3 with the same --out: it loads
<out>/tutorial3_checkpoint, and renders a synthetic hotspot volume when
there is none. The views are 384x384 pixels of 192 samples (--small:
96x96 of 64).
"""
import argparse
import os

import numpy as np

from bhnerf_tpu_torch.tutorials import pyplot

AZIMUTHS = (0.0, 0.8, 1.6)


def main(out_dir='tutorial_outputs', small=False, device='cuda'):
    """Returns what was rendered ('checkpoint' or 'hotspot'), the volume,
    and each view's layers (emission, BH shadow, wireframe, BH shade) as
    (h, w) numpy arrays."""
    from bhnerf_tpu_torch import emission
    from bhnerf_tpu_torch.visualization import (VolumeVisualizer,
                                                layers_to_rgb)

    os.makedirs(out_dir, exist_ok=True)
    fov_M = 16.0
    ckpt = os.path.join(out_dir, 'tutorial3_checkpoint')
    if os.path.isdir(ckpt):
        from bhnerf_tpu_torch.network import sample_checkpoint_3d
        vol = sample_checkpoint_3d(ckpt, fov=fov_M, resolution=64,
                                   device=device)
        source = 'checkpoint'
        print('rendering recovered volume from', ckpt)
    else:
        hotspot = emission.generate_hotspot(
            resolution=(64, 64, 64), rot_axis=[0, 0, 1], rot_angle=0.0,
            orbit_radius=6.6, std=0.7, r_isco=6.0, fov=fov_M)
        vol = hotspot.data.numpy()
        source = 'hotspot'
        print('no checkpoint found; rendering synthetic hotspot volume')

    res = (96, 96) if small else (384, 384)
    vis = VolumeVisualizer(resolution=res, fov=35.0,
                           samples=64 if small else 192, device=device)
    views = [vis.composite(vol, extent=fov_M / 2, azimuth=az,
                           zenith=np.pi / 3, sigma_scale=300.0,
                           bh_radius=2.0, draw_cube=True)
             for az in AZIMUTHS]
    plt = pyplot()
    if plt is not None:
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, az, layers in zip(axes, AZIMUTHS, views):
            ax.imshow(layers_to_rgb(*layers))
            ax.set_title(f'azimuth {az:.1f} rad')
            ax.axis('off')
        path = os.path.join(out_dir, 'tutorial5_volume_render.png')
        fig.savefig(path, dpi=120)
        plt.close('all')
        print('wrote', path)
    return dict(source=source, volume=vol, views=views)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='tutorial_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
