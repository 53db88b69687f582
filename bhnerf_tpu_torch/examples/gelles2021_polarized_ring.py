"""Polarized synchrotron radiation for simple geometries (Gelles 2021).

PyTorch-package counterpart of examples/gelles2021_polarized_ring.py (the
reference's validation notebook "Polarized synchrotron radiation for
simple geometries (Gelles2021).ipynb"): the EVPA ticks around the lensed
image of an equatorial ring and the Q-U loop of an orbiting point source,
for a boosted-ZAMO emitter in a prescribed magnetic field (Gelles et al.
2021, arXiv:2105.09440), then the golden face-on checks:

    python -m bhnerf_tpu_torch.examples.gelles2021_polarized_ring [--small]

The rays are traced on the host in float64; main(backend='device') traces
them with the float32 tracer kernel on `device`, 1 + 40 + 1 launches a
ring's rho_of_req and one for its rays. The figures are drawn where
matplotlib imports; the checks do not depend on them.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def ring_geodesics(spin, inc_deg, req, mbar=0, nphi=64, backend='cpu',
                   device='cuda'):
    """The rays of the lensed equatorial ring (reference :28-38): for each
    of nphi screen azimuths varphi, the screen radius whose mbar-th
    equatorial crossing lands at r = req (rho_of_req), and that ray traced
    at 400 samples. backend and device select the traces as in
    geodesics.trace_geodesics. Returns (varphis, alpha, beta, geos)."""
    from bhnerf_tpu_torch.geodesics import dataset, equatorial

    inc = np.deg2rad(inc_deg)
    varphis = np.linspace(-np.pi, np.pi, nphi, endpoint=False)
    varphis, rho = equatorial.rho_of_req(spin, inc, req, mbar=mbar,
                                         varphis=varphis, ngeo=400,
                                         backend=backend, device=device)
    alpha = rho * np.cos(varphis)
    beta = rho * np.sin(varphis)
    geos = dataset.trace_geodesics(alpha, beta, spin, inc, ngeo=400,
                                   backend=backend, device=device)
    return varphis, alpha, beta, geos


def crossing_stokes(geos, beta_v, chi_deg, b_field, mbar=0,
                    spectral_index=1):
    """The boosted-ZAMO parallel-transported Stokes factors (I, Q, U) at
    each ray's mbar-th equatorial crossing sample (reference :40-51), NaN
    as 0. Returns (3, nrays)."""
    from bhnerf_tpu_torch.geodesics import equatorial
    from bhnerf_tpu_torch.ops import gr

    chi = np.deg2rad(chi_deg)
    g = gr.doppler_factor(geos, gr.zamo_frame_velocity(geos, beta_v, chi))
    bvec = np.broadcast_to(np.asarray(b_field, float), (*geos.r.shape, 3))
    J = np.asarray(gr.parallel_transport_zamo(
        geos, beta_v, chi, g, bvec, Q_frac=1.0,
        spectral_index=spectral_index))
    _, _, idx = equatorial.crossing_index(geos, mbar)
    it = np.arange(geos.r.shape[0])
    stokes = np.stack([J[k][it, idx] for k in range(3)])
    return np.nan_to_num(stokes, nan=0.0)


def ring_stokes(spin, inc_deg, req, beta_v, chi_deg, b_field, mbar=0,
                nphi=64, spectral_index=1, backend='cpu', device='cuda'):
    """Per-azimuth Stokes (I, Q, U) of the lensed equatorial ring image
    (reference :20-51): crossing_stokes on the rays of ring_geodesics.
    Returns (varphis, alpha, beta, stokes (3, nphi))."""
    varphis, alpha, beta, geos = ring_geodesics(spin, inc_deg, req, mbar,
                                                nphi, backend, device)
    return varphis, alpha, beta, crossing_stokes(geos, beta_v, chi_deg,
                                                 b_field, mbar,
                                                 spectral_index)


def golden_face_on(nphi=64, backend='cpu', device='cuda'):
    """The analytic face-on limits of the Gelles2021 configurations
    (reference :101-115) at inclination 1 deg, r = 6, for a static
    emitter: radial B gives azimuthal ticks (EVPA = varphi East of North),
    toroidal B radial ticks, and vertical B is suppressed by
    sin^2(theta_B). The three fields share one ring of rays. Returns the
    largest EVPA deviations (rad) of the radial and toroidal cases and
    the ratio of the vertical case's largest I to the radial case's;
    raises AssertionError when a check fails (3 deg, 3 deg, 0.2)."""
    vv, _, _, geos = ring_geodesics(0.0, 1.0, 6.0, nphi=nphi,
                                    backend=backend, device=device)
    J_rad, J_tor, J_ver = (crossing_stokes(geos, 0.0, 0.0, b)
                           for b in ([1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                                     [0.0, 1.0, 0.0]))
    ang = lambda a, b: np.abs((a - b + np.pi / 2) % np.pi - np.pi / 2)
    evpa = lambda J: 0.5 * np.arctan2(J[2], J[1])
    out = {'radial_evpa_dev': float(ang(evpa(J_rad), vv).max()),
           'toroidal_evpa_dev': float(ang(evpa(J_tor), vv + np.pi / 2)
                                      .max()),
           'vertical_I_ratio': float(J_ver[0].max() / J_rad[0].max())}
    assert out['radial_evpa_dev'] < np.deg2rad(3), out
    assert out['toroidal_evpa_dev'] < np.deg2rad(3), out
    assert out['vertical_I_ratio'] < 0.2, out
    return out


def main(out_dir='example_outputs', small=False, backend='cpu',
         device='cuda'):
    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        from bhnerf_tpu_torch.visualization import plot_evpa_ticks
    except ImportError:
        plt = None

    os.makedirs(out_dir, exist_ok=True)
    nphi = 16 if small else 64
    kw = dict(nphi=nphi, backend=backend, device=device)
    configs = [
        # (label, beta_v, chi_deg, b=[br, bth, bph])  Gelles2021 cases
        ('static, vertical B', 0.0, 0.0, [0.0, 1.0, 0.0]),
        ('static, radial B', 0.0, 0.0, [1.0, 0.0, 0.0]),
        ('boosted, toroidal B', 0.3, -90.0, [0.0, 0.0, 1.0]),
    ]
    if plt is not None:
        fig, axes = plt.subplots(1, len(configs),
                                 figsize=(4 * len(configs), 4))
    # every configuration at 20 deg shares the ring's rays
    varphis, alpha, beta, geos = ring_geodesics(0.0, 20.0, 6.0, **kw)
    for k, (label, bv, chi, b) in enumerate(configs):
        I, Q, U = crossing_stokes(geos, bv, chi, b)
        lp = np.sqrt(Q**2 + U**2)
        if plt is not None:
            ax = np.atleast_1d(axes)[k]
            ax.scatter(alpha, beta, c=I, cmap='afmhot', s=14)
            plot_evpa_ticks(Q, U, alpha, beta, ax=ax, color='royalblue',
                            scale=np.maximum(lp.max() * 8, 1e-8))
            ax.set_aspect('equal')
            ax.set_title(label, fontsize=10)
            ax.set_xlabel(r'$\alpha$ [M]')
        print(f'{label}: DoLP mean {np.mean(lp / np.maximum(I, 1e-12)):.3f},'
              f' I contrast {I.max() / max(I.min(), 1e-12):.2f}')

    # Q-U loop of the orbiting point source (one orbital period)
    J = crossing_stokes(geos, 0.4, -90.0, [0.0, 0.71, 0.71])
    if plt is not None:
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, 'gelles2021_ring_evpa.png'),
                    dpi=130)
        fig2, ax2 = plt.subplots(figsize=(4, 4))
        ax2.plot(J[1], J[2], '.-')
        ax2.set_xlabel('Q')
        ax2.set_ylabel('U')
        ax2.set_title('Q-U loop of orbiting point source')
        ax2.set_aspect('equal')
        fig2.savefig(os.path.join(out_dir, 'gelles2021_qu_loop.png'),
                     dpi=130)

    golden = golden_face_on(**kw)
    print(f'golden face-on EVPA patterns: OK {golden}')
    print('wrote', out_dir)
    return golden


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--out', default='example_outputs')
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.out, args.small)
