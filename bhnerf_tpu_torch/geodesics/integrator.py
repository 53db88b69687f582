"""Kerr null-geodesic integrator in torch (host float64).

PyTorch counterpart of `bhnerf_tpu/geodesics/integrator.py`: second-order
Mino-time RK4 in (u = 1/r, c = cos theta) with a polynomial right-hand
side, Kahan-compensated coordinate time, and two passes (pass 1 finds
each ray's terminal Mino time with a fine step, pass 2 re-integrates and
records `ngeo` uniform samples). Each `lax.scan` of the reference becomes
a Python loop of vectorized tensor ops over the padded ray bucket.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bhnerf_tpu_torch.geodesics import kerr


class RayState(NamedTuple):
    u: torch.Tensor        # inverse radius 1/r
    ud: torch.Tensor       # du/dtau (backward parameterization)
    c: torch.Tensor        # cos(theta)
    cd: torch.Tensor       # dc/dtau (backward)
    phi: torch.Tensor      # azimuth
    t: torch.Tensor        # coordinate time (<= 0 going backward)
    t_c: torch.Tensor      # Kahan compensation for t


def _where(mask, old, new):
    """Per-ray select over every field of two RayStates."""
    return RayState(*(torch.where(mask, o, n) for o, n in zip(old, new)))


def _rk4_step(s: RayState, h, spin, lam, eta, u_clip, u_floor):
    """One classic RK4 step of size h (h may be a per-ray tensor)."""

    def f(u, ud, c, cd):
        # clip u away from the horizon pole of 1/Delta (above) and from
        # u = 0 (below) so frozen or terminated rays cannot poison the
        # step with infinities
        u = torch.clamp(u, u_floor, u_clip)
        return (ud,
                0.5 * kerr.dU_du(u, spin, lam, eta),
                cd,
                0.5 * kerr.dC_dc(c, spin, lam, eta),
                -kerr.phi_rate(u, c, spin, lam),
                -kerr.t_rate(u, c, spin, lam))

    k1 = f(s.u, s.ud, s.c, s.cd)
    k2 = f(s.u + 0.5 * h * k1[0], s.ud + 0.5 * h * k1[1],
           s.c + 0.5 * h * k1[2], s.cd + 0.5 * h * k1[3])
    k3 = f(s.u + 0.5 * h * k2[0], s.ud + 0.5 * h * k2[1],
           s.c + 0.5 * h * k2[2], s.cd + 0.5 * h * k2[3])
    k4 = f(s.u + h * k3[0], s.ud + h * k3[1],
           s.c + h * k3[2], s.cd + h * k3[3])

    def comb(i):
        return (h / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i])

    # Kahan-compensated accumulation of t: it reaches O(r_o) while the
    # physics downstream needs O(1) differences
    dt = comb(5)
    y = dt - s.t_c
    t_new = s.t + y
    t_c = (t_new - s.t) - y

    return RayState(s.u + comb(0), s.ud + comb(1), s.c + comb(2),
                    s.cd + comb(3), s.phi + comb(4), t_new, t_c)


def initial_state(alpha, beta, spin, inc, r_o, dtype=torch.float64):
    """Observer-plane initial conditions for the backward trace; the
    trig of the inclination is evaluated in float64 numpy.
    Returns (RayState, lam, eta) as host tensors of `dtype`."""
    alpha = np.asarray(alpha, np.float64)
    beta = np.asarray(beta, np.float64)
    sin_i, cos_i = np.sin(inc), np.cos(inc)
    lam = -alpha * sin_i
    eta = (alpha**2 - spin**2) * cos_i**2 + beta**2

    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(dtype)
    lam_t, eta_t = as_t(lam), as_t(eta)
    u0 = torch.full_like(lam_t, 1.0 / r_o)
    U0 = kerr.U_potential(u0, spin, lam_t, eta_t)
    # the backward ray leaves the observer inward: du/dtau = +sqrt(U) > 0
    ud0 = torch.sqrt(torch.clamp(U0, min=0.0))
    c0 = torch.full_like(lam_t, cos_i)
    # physical arrival has p_theta = beta; dc/dtau_backward = beta sin(inc)
    cd0 = as_t(beta * sin_i)
    zeros = torch.zeros_like(lam_t)
    return RayState(u0, ud0, c0, cd0, zeros, zeros, zeros), lam_t, eta_t


@torch.no_grad()
def terminal_mino_time(state0, spin, lam, eta, r_o, tau_max=4.0, n_fine=8192,
                       r_stop_factor=1.05):
    """Pass 1: fine fixed-step integration to find each ray's terminal Mino
    time (horizon approach or escape past the observer radius)."""
    dtype = state0.u.dtype
    h = torch.tensor(tau_max / n_fine, dtype=dtype)
    u_horizon = 1.0 / (kerr.horizon(spin) * r_stop_factor)
    u_escape = (1.0 / r_o) * (1.0 - 1e-9)
    u_floor = 0.5 / r_o

    s = state0
    terminated = torch.zeros_like(s.u, dtype=torch.bool)
    tau_term = torch.full_like(s.u, tau_max)
    for i in range(n_fine):
        s_next = _where(terminated, s,
                        _rk4_step(s, h, spin, lam, eta, u_horizon, u_floor))
        hit = (s_next.u >= u_horizon) | (s_next.u <= u_escape)
        newly = hit & ~terminated
        # round DOWN to the last pre-crossing step so pass 2 (whose
        # substeps are coarser) never integrates beyond the stop surfaces
        tau_term = torch.where(newly, float(i) * h, tau_term)
        terminated = terminated | hit
        s = s_next
    return tau_term


@torch.no_grad()
def sample_rays(state0, tau_final, spin, lam, eta, r_o=1000.0, ngeo=100,
                substeps=8, first_substeps=512, r_stop_factor=1.05):
    """Pass 2: re-integrate and record `ngeo` uniform Mino-time samples.

    The first inter-sample segment gets `first_substeps` RK4 sub-steps
    instead of `substeps`: dt/dtau ~ r_o^2 is steeply singular in Mino
    time right at the observer. Returns a dict of (ngeo, nrays) tensors.
    """
    tau_seg = tau_final / (ngeo - 1)
    u_clip = 1.0 / (kerr.horizon(spin) * r_stop_factor)
    u_escape = (1.0 / r_o) * (1.0 - 1e-9)
    u_floor = 0.5 / r_o

    def record(s: RayState):
        return {
            'u': s.u, 'c': s.c, 'phi': s.phi, 't': s.t,
            # running Kahan error of t: the corrected time is t - t_c
            't_c': s.t_c,
            # physical (forward photon) momentum signs
            'pm_r': torch.sign(s.ud),
            'pm_th': torch.sign(s.cd),
        }

    def advance_segment(s, nsub):
        h = tau_seg / nsub
        for _ in range(nsub):
            s3 = _rk4_step(s, h, spin, lam, eta, u_clip, u_floor)
            # hold rays at the horizon-stop surface / escape radius
            # instead of overshooting
            frozen = (s.u >= u_clip) | ((s.u <= u_escape) & (s.ud < 0))
            s3 = _where(frozen, s, s3)
            s = s3._replace(u=torch.clamp(s3.u, min=u_floor))
        return s

    records = [record(state0)]
    s = advance_segment(state0, first_substeps)
    records.append(record(s))
    for _ in range(ngeo - 2):
        s = advance_segment(s, substeps)
        records.append(record(s))
    return {k: torch.stack([r[k] for r in records]) for k in records[0]}
