"""Equatorial lensing: crossings of the equator and their inversion.

PyTorch-package counterpart of `bhnerf_tpu/geodesics/equatorial.py` (the
kgeo.equatorial_lensing equivalents of the reference): the Mino time and
radius of the mbar-th equatorial crossing of each ray (`r_equatorial`,
consumed by emission.equatorial_ring), and the screen radius whose
crossing lands on a given equatorial radius (`rho_of_req`, the
Gelles2021 point-source placement). Crossings are found in numpy on the
host over a table that `dataset.trace_geodesics` returned. The tracing
functions take the reference's arguments, and besides them `backend`,
`device` and `n_fine`, which they pass to trace_geodesics: the host
float64 trace by default, or with backend='device' the float32 tracer
kernel on `device`, one launch a trace.
"""
from __future__ import annotations

import numpy as np

from bhnerf_tpu_torch.geodesics import dataset as dataset_lib


def crossing_index(geos, mbar):
    """Locate the (mbar+1)-th equatorial crossing of each ray, the single
    place crossings are detected (also used by emission.equatorial_ring
    and the Gelles2021 example).

    Returns (found, idx, idx_nearest): `idx` is the sample before the
    crossing (the crossing lies in [idx, idx+1]); `idx_nearest` is
    whichever of the two samples has the smaller |cos(theta)|.
    """
    ct = np.cos(geos.theta)
    sign_change = np.signbit(ct[..., 1:]) != np.signbit(ct[..., :-1])
    order = np.cumsum(sign_change, axis=-1)
    is_mth = (order == mbar + 1) & sign_change
    found = is_mth.any(axis=-1)
    idx = np.argmax(is_mth, axis=-1)
    it = np.indices(idx.shape)
    nearer_next = np.abs(ct[(*it, idx)]) > np.abs(ct[(*it, idx + 1)])
    idx_nearest = np.where(nearer_next, idx + 1, idx)
    return found, idx, idx_nearest


def equatorial_crossing_quantities(geos, mbar):
    """Interpolated (r, mino, t, phi) of the (mbar+1)-th equatorial
    crossing of each ray; NaN where the ray has fewer crossings."""
    ct = np.cos(geos.theta)
    found, idx, _ = crossing_index(geos, mbar)
    it = np.indices(idx.shape)

    # linear interpolation in cos(theta) across the crossing interval:
    # c0 + w (c1 - c0) = 0  =>  w = c0 / (c0 - c1)
    c0 = ct[(*it, idx)]
    c1 = ct[(*it, idx + 1)]
    denom = np.where(np.abs(c0 - c1) > 0, c0 - c1, 1.0)
    w = np.clip(c0 / denom, 0.0, 1.0)

    def interp(arr):
        a0 = arr[(*it, idx)]
        a1 = arr[(*it, idx + 1)]
        return np.where(found, a0 + w * (a1 - a0), np.nan)

    return {'found': found, 'r': interp(geos.r), 'mino': interp(geos.mino),
            't': interp(geos.t), 'phi': interp(geos.phi)}


def r_equatorial(spin, r_o, inc, mbar, alpha, beta, ngeo=400,
                 distance=1000.0, backend='cpu', device='cuda',
                 n_fine=8192):
    """Radius and Mino time of the mbar-th equatorial crossing of the rays
    through screen points (alpha, beta) (kgeo.equatorial_lensing.
    r_equatorial parity; `r_o` is accepted and not read, as there).
    Returns (r, mino) arrays shaped like alpha, NaN where a ray crosses
    fewer times."""
    del r_o
    alpha = np.atleast_1d(np.asarray(alpha, float))
    beta = np.atleast_1d(np.asarray(beta, float))
    geos = dataset_lib.trace_geodesics(alpha, beta, spin, inc, ngeo=ngeo,
                                       distance=distance, n_fine=n_fine,
                                       backend=backend, device=device)
    q = equatorial_crossing_quantities(geos, mbar)
    return q['r'], q['mino']


def rho_of_req(spin, inc, req, mbar=0, varphis=None, rho_min=1.0,
               rho_max=12.0, iters=40, ngeo=400, distance=1000.0,
               backend='cpu', device='cuda', n_fine=8192):
    """Screen radius rho(varphi) whose mbar-th equatorial crossing lands
    at Boyer-Lindquist radius `req` (Gelles2021 point-source placement).

    A 48-point scan of rho in one trace brackets the root of each varphi,
    `iters` bisection steps each trace len(varphis) rays, and one more
    trace checks the result: a varphi whose crossing misses req by more
    than 1e-2 max(|req|, 1) is NaN. That is 1 + iters + 1 traces.
    Returns (varphis, rho) arrays.
    """
    if varphis is None:
        varphis = np.linspace(-np.pi, np.pi, 64)
    varphis = np.atleast_1d(np.asarray(varphis, float))
    nphi = varphis.size

    def crossing_r(rho):
        phis = varphis if rho.ndim == 1 else varphis[None, :]
        r, _ = r_equatorial(spin, np.inf, inc, mbar,
                            (rho * np.cos(phis)).ravel(),
                            (rho * np.sin(phis)).ravel(), ngeo=ngeo,
                            distance=distance, backend=backend,
                            device=device, n_fine=n_fine)
        return r.reshape(rho.shape)

    # 1) coarse scan to bracket: the mbar-th crossing only exists inside a
    # finite rho window (below it the ray plunges first, above it the ray
    # never winds enough), and r(rho) increases within that window
    n_scan = 48
    rho_grid = np.linspace(rho_min, rho_max, n_scan)
    rho_2d = np.broadcast_to(rho_grid[:, None], (n_scan, nphi)).copy()
    r_scan = crossing_r(rho_2d)
    # the first grid point whose crossing exists with r >= req brackets
    # the solution from above (NaN lies both below and above the window)
    ok = np.isfinite(r_scan) & (r_scan >= req)
    bracketed = ok.any(axis=0)
    idx_hi = np.clip(np.argmax(ok, axis=0), 1, n_scan - 1)
    hi = rho_grid[idx_hi]
    lo = rho_grid[idx_hi - 1]

    # 2) bisection inside the bracket
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        r_mid = crossing_r(mid)
        too_small = np.isnan(r_mid) | (r_mid < req)
        lo = np.where(too_small, mid, lo)
        hi = np.where(too_small, hi, mid)
    rho = 0.5 * (lo + hi)
    # a bracket can also form at the edge of the existence window when req
    # lies outside the reachable crossing radii; the bisection then
    # converges on the window's edge, not on r == req, so re-trace and NaN
    # every root whose crossing misses req
    r_final = crossing_r(rho)
    good = (bracketed & np.isfinite(r_final)
            & (np.abs(r_final - req) <= 1e-2 * max(abs(req), 1.0)))
    return varphis, np.where(good, rho, np.nan)
