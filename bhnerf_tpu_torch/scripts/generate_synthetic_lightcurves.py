"""Generate a synthetic polarized-lightcurve dataset.

PyTorch counterpart of scripts/generate_synthetic_lightcurves.py (the
reference's "Synthetic lightcurves 0 - Generate data" notebook): renders
the I, Q and U lightcurves of an orbiting hotspot, a flux tube or a double
hotspot through the polarized GR forward model on the card, adds noise to
Q and U, and writes what fit_synthetic_lp_flares reads:

    python -m bhnerf_tpu_torch.scripts.generate_synthetic_lightcurves \\
        --name hotspot_i60 --inc 60 --source hotspot --out ../data

Outputs, in --out: <name>_lightcurves.csv (t in hours, I, Q, U in Jy),
<name>_flare.npz (the 3D truth: data, start, stop) and <name>.yaml (the
name, both paths and the model block). The arguments are the reference's;
like there, --ngeo is accepted and not read (the tables have 100 samples
a ray). The geodesics are traced on the host in float64 and the movie is
rendered on the card; DRIVE_CPU=1 in the environment renders on the host.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--name', default='synthetic_hotspot')
    p.add_argument('--out', default='data')
    p.add_argument('--inc', type=float, default=60.0, help='deg')
    p.add_argument('--spin', type=float, default=0.0)
    p.add_argument('--source', default='hotspot',
                   choices=['hotspot', 'tube', 'double'])
    p.add_argument('--fov_M', type=float, default=40.0)
    p.add_argument('--num_alpha', type=int, default=64)
    p.add_argument('--num_beta', type=int, default=64)
    p.add_argument('--ngeo', type=int, default=100)
    p.add_argument('--nt', type=int, default=123)
    p.add_argument('--t_start', type=float, default=9.34, help='hr')
    p.add_argument('--duration', type=float, default=1.67, help='hr')
    p.add_argument('--Q_frac', type=float, default=0.85)
    p.add_argument('--I_flux', type=float, default=0.3, help='Jy')
    p.add_argument('--P_flux', type=float, default=0.1, help='Jy')
    p.add_argument('--noise', type=float, default=0.0,
                   help='gaussian noise std on Q/U [Jy]')
    p.add_argument('--seed', type=int, default=0)
    return p.parse_args(argv)


def source_volume(source, r_isco, fov_M, res=(64, 64, 64)):
    """The 3D truth of `source` on a res grid over fov_M (reference
    :67-80): a hotspot at 1.5 r_isco, a quarter-orbit tube there, or that
    hotspot plus 0.6 of a second one opposite it at 1.3 times its
    radius."""
    from bhnerf_tpu_torch import emission, utils
    orbit_r = 1.5 * r_isco
    if source == 'hotspot':
        return emission.generate_hotspot(res, [0, 0, 1], 0.0, orbit_r, 1.2,
                                         r_isco, fov_M)
    if source == 'tube':
        return emission.generate_tube(res, [0, 0, 1], 0.0, np.pi / 2,
                                      orbit_r, 1.2, r_isco, fov_M)
    v1 = emission.generate_hotspot(res, [0, 0, 1], 0.0, orbit_r, 1.2,
                                   r_isco, fov_M)
    v2 = emission.generate_hotspot(res, [0, 0, 1], np.pi, 1.3 * orbit_r,
                                   1.0, r_isco, fov_M)
    return utils.Grid3D(v1.data + 0.6 * v2.data, v1.start, v1.stop)


def main(argv=None):
    import pandas as pd
    import yaml

    from bhnerf_tpu_torch import alma, constants, emission, units

    args = parse_args(argv)
    device = 'cpu' if os.environ.get('DRIVE_CPU') else 'cuda'
    inc = np.deg2rad(args.inc)
    model_params = {
        'spin': args.spin, 'fov_M': args.fov_M, 'z_width': 4.0,
        'rmin': 'ISCO', 'Q_frac': args.Q_frac,
        'b_consts': {'arad': 0, 'avert': 1, 'ator': 0},
        'Omega_dir': 'cw', 'Omega_frac': 1.0,
        'num_alpha': args.num_alpha, 'num_beta': args.num_beta,
        't_start_obs': args.t_start,
    }
    geos, Omega, J = alma.image_plane_model(inc, args.spin, model_params)
    vol = source_volume(args.source, float(constants.isco_pro(args.spin)),
                        args.fov_M)

    t_frames = units.Quantity(
        args.t_start + np.linspace(0, args.duration, args.nt), 'hr')
    t_injection = -float(geos.r_o + args.fov_M / 4)
    movie = emission.image_plane_dynamics(
        vol, geos, Omega, t_frames, t_injection, J=J,
        t_start_obs=t_frames[0], device=device)  # (nt, nstokes, na, nb)
    movie = emission.normalize_stokes(movie.cpu().numpy(), args.I_flux,
                                      args.P_flux)
    lc = movie.sum(axis=(-1, -2))  # (nt, nstokes)

    rng = np.random.default_rng(args.seed)
    if args.noise > 0:
        lc[:, 1:] += rng.normal(0, args.noise, lc[:, 1:].shape)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / f'{args.name}_lightcurves.csv'
    pd.DataFrame({'t': np.asarray(t_frames.value), 'I': lc[:, 0],
                  'Q': lc[:, 1], 'U': lc[:, 2]}).to_csv(csv_path,
                                                        index=False)
    flare_path = out_dir / f'{args.name}_flare.npz'
    np.savez(flare_path, data=vol.data.numpy(), start=np.asarray(vol.start),
             stop=np.asarray(vol.stop))

    sim_yaml = out_dir / f'{args.name}.yaml'
    with open(sim_yaml, 'w') as f:
        yaml.dump({
            'name': args.name,
            'lightcurve_path': str(csv_path),
            'flare_path': str(flare_path),
            'model': model_params | {'emission_scale': 1.0},
        }, f, default_flow_style=False)
    print(f'wrote {csv_path}, {flare_path}, {sim_yaml}')
    print('fit with: python -m bhnerf_tpu_torch.scripts.'
          f'fit_synthetic_lp_flares {sim_yaml} <inc>')
    return dict(csv=csv_path, flare=flare_path, yaml=sim_yaml)


if __name__ == '__main__':
    main()
