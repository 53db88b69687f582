"""Tutorial 2: synthesize ngEHT observations of an orbiting hotspot.

PyTorch-package counterpart of
tutorials/tutorial2_synthesize_ngeht_observations.py (the reference's
"Tutorial2 - synthesize ngEHT observations" notebook): render the movie
of an orbiting hotspot through the GR renderer on the card, then observe
it with the ngEHT array (uv coverage, thermal noise).

    python -m bhnerf_tpu_torch.tutorials.tutorial2_synthesize_ngeht_observations \\
        [--small] [--out DIR]
"""
import argparse
import os

import numpy as np

from bhnerf_tpu_torch.tutorials import array_path, pyplot


def main(out_dir='tutorial_outputs', small=False, device='cuda'):
    """Returns the movie (nt, num, num), its frame times [hr], the
    observation's visibilities and mask, its scan count and the count of
    valid baselines; writes tutorial2_data.npz (movie, t_frames)."""
    from bhnerf_tpu_torch import constants, emission, observation, units
    from bhnerf_tpu_torch.geodesics import image_plane_geos

    os.makedirs(out_dir, exist_ok=True)
    spin, inc = 0.2, np.deg2rad(60.0)
    fov_M = 16.0
    num = 16 if small else 64
    ngeo = 32 if small else 100
    nt = 8 if small else 64

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
    flux = movie.sum((-1, -2))
    print('movie:', movie.shape, 'flux range', flux.min(), flux.max())

    # observe with ngEHT: uv coverage + thermal noise
    array = observation.load_txt(array_path('ngEHT.txt'))
    obs_empty = observation.empty_eht_obs(array, nt=nt, tint=30.0,
                                          tstart=4.0, tstop=15.5)
    fov_rad = (fov_M * constants.GM_c2(constants.sgra_mass).value
               / constants.sgra_distance.to('m').value)
    psize = fov_rad / num
    obs = observation.observe_same(movie, np.asarray(t_frames.value) + 4.0,
                                   psize, obs_empty, thermal_noise=True,
                                   seed=0)
    n_valid = int(obs.mask.sum())
    print('observation: nscan', obs.nscan, 'valid baselines', n_valid)
    np.savez(os.path.join(out_dir, 'tutorial2_data.npz'), movie=movie,
             t_frames=np.asarray(t_frames.value))

    plt = pyplot()
    if plt is not None:
        ax = observation.plot_uv_coverage(obs)
        ax.get_figure().savefig(os.path.join(out_dir, 'tutorial2_uv.png'),
                                dpi=120)
        plt.close('all')
        fig, axes = plt.subplots(1, 4, figsize=(12, 3))
        for k, ax in enumerate(axes):
            ax.imshow(movie[k * (nt // 4)], cmap='afmhot')
            ax.set_title(
                f't = {float(t_frames.value[k * (nt // 4)]):.2f} hr')
            ax.axis('off')
        fig.savefig(os.path.join(out_dir, 'tutorial2_frames.png'), dpi=120)
        plt.close('all')
    print('wrote', out_dir)
    return dict(movie=movie, t_frames=np.asarray(t_frames.value),
                vis=obs.vis, mask=obs.mask, nscan=obs.nscan,
                n_valid=n_valid, flux=(float(flux.min()), float(flux.max())))


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='tutorial_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
