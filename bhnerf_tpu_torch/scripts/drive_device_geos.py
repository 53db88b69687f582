"""Drive: the float32 geodesic trace on the card against the float64 host
trace (port of scripts/drive_device_geos.py).

Traces the chi^2-scan table (spin 0.94, inclination 60 deg, fov 16 M,
npix x npix rays x 100 samples, the tracer's default 8192 fine steps) on
the host in float64 and with backend='device' in float32 on the card,
prints the seconds of both and holds the float32 table to the reference's
accuracy gate (`compare`). Exits 1 on a regression.

    python -m bhnerf_tpu_torch.scripts.drive_device_geos [npix]
"""
from __future__ import annotations

import sys
import time

import numpy as np

FOV = 16.0


def compare(test, truth, fov):
    """The reference's gate for a float32 table against its float64 truth
    (scripts/drive_device_geos.py, tests/test_geodesics.py:318-366).
    test, truth: (r, theta, t) arrays of one shape, t the Kahan-folded
    float64 time. Near-critical rays diverge exponentially in float32, so
    the bulk is judged on quantiles, never on the global max:
      * p90 of dr / max(r, 1) < 1e-4, of |dtheta| < 1e-3, of |dt| < 1e-3;
      * inside the emission domain as the float32 table's own radii give
        it (r <= fov, the mask consumers apply): max |dt| < 1 M and p99
        < 1e-2;
      * no divergent re-entry: no sample in that domain whose true r is
        beyond 2 fov.
    Returns a dict of the quantiles and `ok`, and beside them the 99th
    percentiles of dr / max(r, 1) and |dtheta|, which the gate leaves
    out."""
    r, theta, t = (np.asarray(x) for x in test)
    r0, theta0, t0 = (np.asarray(x) for x in truth)
    dr = np.abs(r - r0) / np.maximum(r0, 1.0)
    dth = np.abs(theta - theta0)
    dt = np.abs(t - t0)
    in_dom = r <= fov
    out = {
        'p90_dr_rel': float(np.quantile(dr, 0.9)),
        'p90_dtheta': float(np.quantile(dth, 0.9)),
        'p90_dt': float(np.quantile(dt, 0.9)),
        'p99_dr_rel': float(np.quantile(dr, 0.99)),
        'p99_dtheta': float(np.quantile(dth, 0.99)),
        'median_dt': float(np.median(dt)),
        'max_dt': float(dt.max()),
        'n_in_domain': int(in_dom.sum()),
        'in_domain_max_dt': float(dt[in_dom].max()) if in_dom.any() else 0.0,
        'in_domain_p99_dt': (float(np.quantile(dt[in_dom], 0.99))
                             if in_dom.any() else 0.0),
        'reentries': int((in_dom & (r0 > 2 * fov)).sum()),
    }
    out['ok'] = bool(out['p90_dr_rel'] < 1e-4 and out['p90_dtheta'] < 1e-3
                     and out['p90_dt'] < 1e-3
                     and out['in_domain_max_dt'] < 1.0
                     and out['in_domain_p99_dt'] < 1e-2
                     and out['reentries'] == 0)
    return out


def compare_phi_signs(r, test, truth, same, fov):
    """The fields `compare` leaves out, for a float32 table against
    another trace of the same rays. r: the test table's radii; test,
    truth: (phi, pm_r, pm_th), all (rays, ngeo); same: (rays,) bool, the
    rays whose terminal Mino time agrees in both traces.
      * phi under t's gate: p90 |dphi| < 1e-3, and where r <= fov max < 1
        and p99 < 1e-2, with dphi the raw difference (phi is not wrapped)
        over max(|phi|, 1) of the truth, as `compare` takes dr over
        max(r, 1): a ray that grazes a pole of the coordinates (1 - c^2
        under its floor of 1e-12) runs phi up to ~1e8 rad in every trace,
        float64 too, where one float32 ulp is 8 rad;
      * the momentum signs pm_r and pm_th equal on every sample of the
        rays in `same` (a ray that stops a fine step apart samples other
        Mino times, so its signs may differ next to a turning point).
    Returns a dict of the numbers and `ok`."""
    phi, pm_r, pm_th = (np.asarray(x) for x in test)
    phi0, pm_r0, pm_th0 = (np.asarray(x) for x in truth)
    same = np.asarray(same, bool)
    dphi = (np.abs(phi.astype(np.float64) - phi0)
            / np.maximum(np.abs(phi0), 1.0))
    in_dom = np.asarray(r) <= fov
    out = {
        'p90_dphi': float(np.quantile(dphi, 0.9)),
        'median_dphi': float(np.median(dphi)),
        'max_dphi': float(dphi.max()),
        'in_domain_max_dphi': (float(dphi[in_dom].max()) if in_dom.any()
                               else 0.0),
        'in_domain_p99_dphi': (float(np.quantile(dphi[in_dom], 0.99))
                               if in_dom.any() else 0.0),
        'pm_r_mismatches': int((pm_r != pm_r0)[same].sum()),
        'pm_th_mismatches': int((pm_th != pm_th0)[same].sum()),
        'pm_mismatches_other_rays': int(((pm_r != pm_r0)
                                         | (pm_th != pm_th0))[~same].sum()),
    }
    out['ok'] = bool(out['p90_dphi'] < 1e-3
                     and out['in_domain_max_dphi'] < 1.0
                     and out['in_domain_p99_dphi'] < 1e-2
                     and out['pm_r_mismatches'] == 0
                     and out['pm_th_mismatches'] == 0)
    return out


def describe_phi_signs(q):
    """One line of `compare_phi_signs`' numbers."""
    return (f'p90 dphi/max(|phi|, 1) {q["p90_dphi"]:.2e} (median '
            f'{q["median_dphi"]:.2e}, max {q["max_dphi"]:.2e}), in domain '
            f'max {q["in_domain_max_dphi"]:.2e}, p99 '
            f'{q["in_domain_p99_dphi"]:.2e}; signs differ on '
            f'{q["pm_r_mismatches"]} pm_r and {q["pm_th_mismatches"]} pm_th '
            f'samples of the rays of the same tau_final '
            f'({q["pm_mismatches_other_rays"]} on the others)')


def table(geos):
    """(r, theta, t) of a Geodesics, as `compare` takes them."""
    return geos.r, geos.theta, geos.t


def describe(q):
    """One line of `compare`'s numbers."""
    return (f'p90 dr/r {q["p90_dr_rel"]:.2e}, dtheta {q["p90_dtheta"]:.2e}, '
            f'|dt| {q["p90_dt"]:.2e} (median {q["median_dt"]:.2e}, max '
            f'{q["max_dt"]:.2e}); in domain ({q["n_in_domain"]} samples) '
            f'max |dt| {q["in_domain_max_dt"]:.2e}, p99 '
            f'{q["in_domain_p99_dt"]:.2e}; re-entries {q["reentries"]}')


def drive(npix=64, device='cuda', log=print):
    """Trace the drive's table on the host (float64) and on `device`
    (float32, twice: the first call builds the kernel), print the seconds
    and the gate. Returns a dict of the seconds and `compare`'s numbers."""
    import torch

    from bhnerf_tpu_torch.geodesics import image_plane_geos

    kw = dict(spin=0.94, inclination=np.deg2rad(60), alpha_range=(-8, 8),
              beta_range=(-8, 8), ngeo=100, num_alpha=npix, num_beta=npix)
    t0 = time.perf_counter()
    g64 = image_plane_geos(**kw)
    host_s = time.perf_counter() - t0
    log(f'drive {npix}x{npix}x100: host f64 trace {host_s:.2f} s')
    seconds = []
    for _ in range(2):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        g32 = image_plane_geos(**kw, backend='device', device=device)
        seconds.append(time.perf_counter() - t0)
    log(f'drive: device f32 trace {seconds[1]:.3f} s (the first call, which '
        f'builds the kernel if it is not built yet, {seconds[0]:.2f} s): '
        f'{host_s / seconds[1]:.0f}x the host')
    q = compare(table(g32), table(g64), FOV)
    log(f'drive: {describe(q)}')
    log('ACCURACY OK' if q['ok'] else 'ACCURACY REGRESSION')
    return {'npix': npix, 'host_s': host_s, 'device_s': seconds[1],
            'device_first_s': seconds[0], **q}


def main(argv=None):
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print('drive_device_geos: no CUDA device', file=sys.stderr)
        return 1
    npix = int(argv[0]) if argv else 64
    log = lambda msg: print(msg, flush=True)
    log(f'{torch.cuda.get_device_name(0)}, torch {torch.__version__}')
    return 0 if drive(npix, torch.device('cuda', 0), log)['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
