"""Kerr null geodesics in numpy float64, for a handful of rays.

A frozen copy of the port's plain tracer (`geodesics/integrator.py` and
`geodesics/kerr.py` of bhnerf_tpu_torch, the two-pass Mino-time RK4 in
u = 1/r and c = cos(theta)), rewritten in numpy so that the benchmark can
trace the rays it checks without the program and without a launch per
operation. The arithmetic is the plain version's, in its order.
"""
from __future__ import annotations

import math

import numpy as np


def horizon(spin):
    return 1.0 + math.sqrt(1.0 - spin**2)


def conserved_quantities(alpha, beta, spin, inc):
    lam = -alpha * np.sin(inc)
    eta = (alpha**2 - spin**2) * np.cos(inc) ** 2 + beta**2
    return lam, eta


def delta(r, spin):
    return r**2 - 2.0 * r + spin**2


def sigma(r, theta, spin):
    return r**2 + spin**2 * np.cos(theta) ** 2


def r_potential(r, spin, lam, eta):
    return ((r**2 + spin**2 - spin * lam) ** 2
            - delta(r, spin) * (eta + (lam - spin) ** 2))


def theta_potential(theta, spin, lam, eta):
    cos2, sin2 = np.cos(theta) ** 2, np.sin(theta) ** 2
    return eta + spin**2 * cos2 - lam**2 * cos2 / sin2


def _u_potential(u, spin, lam, eta):
    c2 = spin**2 - spin * lam
    k = eta + (lam - spin) ** 2
    a_ = 1.0 + c2 * u**2
    return a_**2 - (1.0 - 2.0 * u + spin**2 * u**2) * u**2 * k


def _du(u, spin, lam, eta):
    c2 = spin**2 - spin * lam
    k = eta + (lam - spin) ** 2
    a_ = 1.0 + c2 * u**2
    return 4.0 * c2 * u * a_ - k * (2.0 * u - 6.0 * u**2
                                    + 4.0 * spin**2 * u**3)


def _dc(c, spin, lam, eta):
    return 2.0 * (spin**2 - eta - lam**2) * c - 4.0 * spin**2 * c**3


def _phi_rate(u, c, spin, lam):
    r = 1.0 / u
    d = delta(r, spin)
    sin2 = np.maximum(1.0 - c**2, 1e-12)
    return spin / d * (r**2 + spin**2 - spin * lam) + lam / sin2 - spin


def _t_rate(u, c, spin, lam):
    r = 1.0 / u
    d = delta(r, spin)
    return ((r**2 + spin**2) / d * (r**2 + spin**2 - spin * lam)
            + spin * (lam - spin * (1.0 - c**2)))


def _rk4(s, h, spin, lam, eta, u_clip, u_floor):
    """One RK4 step of the state s = (u, ud, c, cd, phi, t, t_c)."""
    def f(u, ud, c, cd):
        u = np.clip(u, u_floor, u_clip)
        return (ud, 0.5 * _du(u, spin, lam, eta), cd,
                0.5 * _dc(c, spin, lam, eta), -_phi_rate(u, c, spin, lam),
                -_t_rate(u, c, spin, lam))

    u, ud, c, cd, phi, t, t_c = s
    k1 = f(u, ud, c, cd)
    k2 = f(u + 0.5 * h * k1[0], ud + 0.5 * h * k1[1], c + 0.5 * h * k1[2],
           cd + 0.5 * h * k1[3])
    k3 = f(u + 0.5 * h * k2[0], ud + 0.5 * h * k2[1], c + 0.5 * h * k2[2],
           cd + 0.5 * h * k2[3])
    k4 = f(u + h * k3[0], ud + h * k3[1], c + h * k3[2], cd + h * k3[3])
    comb = [(h / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i])
            for i in range(6)]
    y = comb[5] - t_c
    t_new = t + y
    return (u + comb[0], ud + comb[1], c + comb[2], cd + comb[3],
            phi + comb[4], t_new, (t_new - t) - y)


def _select(mask, old, new):
    return tuple(np.where(mask, o, n) for o, n in zip(old, new))


def trace(alpha, beta, spin, inc, ngeo=100, n_fine=8192, r_o=1000.0,
          tau_max=4.0, substeps=8, first_substeps=512, r_stop_factor=1.05):
    """Trace the rays through screen points alpha, beta (1-d, M units) of
    an observer at inclination `inc` (rad). Returns a dict of (n, ngeo)
    float64 arrays r, theta, phi, t (t - t_c folded), pm_r, pm_th, dtau,
    and the (n,) lam, eta."""
    inc = float(np.clip(inc, 1e-6, np.pi - 1e-6))
    alpha = np.asarray(alpha, np.float64)
    beta = np.asarray(beta, np.float64)
    lam, eta = conserved_quantities(alpha, beta, spin, inc)
    u0 = np.full_like(lam, 1.0 / r_o)
    ud0 = np.sqrt(np.maximum(_u_potential(u0, spin, lam, eta), 0.0))
    c0 = np.full_like(lam, np.cos(inc))
    cd0 = beta * np.sin(inc)
    zeros = np.zeros_like(lam)
    s0 = (u0, ud0, c0, cd0, zeros, zeros, zeros)
    u_clip = 1.0 / (horizon(spin) * r_stop_factor)
    u_escape = (1.0 / r_o) * (1.0 - 1e-9)
    u_floor = 0.5 / r_o

    # pass 1: each ray's terminal Mino time on the fine grid; every 256
    # steps the rays that have ended leave the arrays (each ray's own
    # arithmetic is unchanged by it)
    h = tau_max / n_fine
    tau_final = np.full_like(lam, tau_max)
    live = np.arange(lam.size)
    s, lam_l, eta_l = s0, lam, eta
    done = np.zeros(lam.shape, bool)
    for i in range(n_fine):
        s_next = _select(done, s, _rk4(s, h, spin, lam_l, eta_l, u_clip,
                                       u_floor))
        hit = (s_next[0] >= u_clip) | (s_next[0] <= u_escape)
        tau_final[live[hit & ~done]] = i * h
        done |= hit
        s = s_next
        if i % 256 == 255:
            if done.all():
                break
            keep = ~done
            live, lam_l, eta_l, done = (live[keep], lam_l[keep],
                                        eta_l[keep], done[keep])
            s = tuple(x[keep] for x in s)

    # pass 2: ngeo uniform Mino-time samples
    seg = tau_final / (ngeo - 1)

    def advance(s, nsub):
        hs = seg / nsub
        for _ in range(nsub):
            s3 = _rk4(s, hs, spin, lam, eta, u_clip, u_floor)
            frozen = (s[0] >= u_clip) | ((s[0] <= u_escape) & (s[1] < 0))
            s3 = _select(frozen, s, s3)
            s = (np.maximum(s3[0], u_floor),) + s3[1:]
        return s

    records = [s0]
    s = advance(s0, first_substeps)
    records.append(s)
    for _ in range(ngeo - 2):
        s = advance(s, substeps)
        records.append(s)
    rec = [np.stack([r[k] for r in records], axis=-1) for k in range(7)]
    u, ud, c, cd, phi, t, t_c = rec
    return {'r': 1.0 / u, 'theta': np.arccos(np.clip(c, -1.0, 1.0)),
            'phi': phi, 't': t - t_c, 'pm_r': np.sign(ud),
            'pm_th': np.sign(cd),
            'dtau': np.broadcast_to(seg[:, None], u.shape).copy(),
            'lam': lam, 'eta': eta}
