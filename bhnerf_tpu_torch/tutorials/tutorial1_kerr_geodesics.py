"""Tutorial 1: Kerr geodesics.

PyTorch-package counterpart of tutorials/tutorial1_kerr_geodesics.py (the
reference's "Tutorial1 - Kerr geodesics" notebook): trace the null
geodesics of a spinning black hole over the image plane, inspect the
table, and view rays in 3D with the black-hole shadow.

    python -m bhnerf_tpu_torch.tutorials.tutorial1_kerr_geodesics \\
        [--small] [--out DIR]

The table is the reference's host float64 trace (64x64 rays x 100
samples; --small 16x16 x 32).
"""
import argparse
import os

import numpy as np

from bhnerf_tpu_torch.tutorials import pyplot


def main(out_dir='tutorial_outputs', small=False, device='cuda'):
    """Returns the table's shape, the prograde ISCO, the range of t along
    the rays and the share of rays captured (r_min < 2.5 M). `device` is
    passed to image_plane_geos, whose host trace does not use it."""
    from bhnerf_tpu_torch import constants, visualization
    from bhnerf_tpu_torch.geodesics import image_plane_geos

    os.makedirs(out_dir, exist_ok=True)
    spin = 0.2
    inclination = np.deg2rad(60.0)
    num = 16 if small else 64
    ngeo = 32 if small else 100

    geos = image_plane_geos(spin, inclination, alpha_range=(-10, 10),
                            beta_range=(-10, 10), ngeo=ngeo,
                            num_alpha=num, num_beta=num, device=device)
    isco = float(constants.isco_pro(spin))
    t_range = (float(geos.t.min()), float(geos.t.max()))
    print('geodesics:', geos.r.shape, 'fields: r,theta,phi,t,mino,dtau,...')
    print(f'ISCO (prograde): {isco:.3f} M')
    print(f't range along rays: [{t_range[0]:.1f}, {t_range[1]:.1f}] M')

    # black-hole shadow: minimum radius per ray
    shadow = geos.r.min(axis=-1) < 2.5
    plt = pyplot()
    if plt is not None:
        ax = visualization.plot_geodesic_3D(geos)
        ax.get_figure().savefig(os.path.join(out_dir, 'tutorial1_rays.png'),
                                dpi=120)
        plt.close('all')
        plt.figure(figsize=(4, 4))
        plt.imshow(shadow, extent=[-10, 10, -10, 10], cmap='gray_r')
        plt.xlabel(r'$\beta$ [M]')
        plt.ylabel(r'$\alpha$ [M]')
        plt.title('captured rays (shadow)')
        plt.savefig(os.path.join(out_dir, 'tutorial1_shadow.png'), dpi=120)
        plt.close('all')
        print('wrote', out_dir)
    return dict(shape=geos.r.shape, isco=isco, t_range=t_range,
                captured=float(shadow.mean()))


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='tutorial_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
