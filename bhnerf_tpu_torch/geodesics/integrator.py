"""Kerr null-geodesic integrator in torch.

PyTorch counterpart of `bhnerf_tpu/geodesics/integrator.py`: second-order
Mino-time RK4 in (u = 1/r, c = cos theta) with a polynomial right-hand
side, Kahan-compensated coordinate time, and two passes (pass 1 finds
each ray's terminal Mino time with a fine step, pass 2 re-integrates and
records `ngeo` uniform samples).

Two versions of the same function. The plain one (`terminal_mino_time`,
`sample_rays`, both in `trace_rays_plain`) turns each `lax.scan` of the
reference into a Python loop of vectorized tensor ops over the rays, in
the dtype of its inputs on their device: the host float64 trace, and in
float32 the plain version of the kernel. `trace_rays` is the on-device
float32 trace: one launch of the CUDA kernel `ops/csrc/geodesic_trace.cu`
for a CUDA tensor, the plain version for a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from bhnerf_tpu_torch.geodesics import kerr
from bhnerf_tpu_torch.ops import _build


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
    lam, eta = kerr.conserved_quantities(alpha, beta, spin, inc)

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


def _stop_constants(spin, r_o, r_stop_factor):
    """(u_clip, u_escape, u_floor): the horizon-stop surface, the escape
    radius and the floor of u, as Python floats (both passes)."""
    return (1.0 / (kerr.horizon(spin) * r_stop_factor),
            (1.0 / r_o) * (1.0 - 1e-9), 0.5 / r_o)


@torch.no_grad()
def terminal_mino_time(state0, spin, lam, eta, r_o, tau_max=4.0, n_fine=8192,
                       r_stop_factor=1.05):
    """Pass 1: fine fixed-step integration to find each ray's terminal Mino
    time (horizon approach or escape past the observer radius)."""
    dtype = state0.u.dtype
    h = torch.tensor(tau_max / n_fine, dtype=dtype, device=state0.u.device)
    u_horizon, u_escape, u_floor = _stop_constants(spin, r_o,
                                                   r_stop_factor)

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
        # once every ray has stopped, later steps change nothing (a check
        # every 256 steps, so the card is not synchronised each step)
        if i % 256 == 255 and bool(terminated.all()):
            break
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
    u_clip, u_escape, u_floor = _stop_constants(spin, r_o, r_stop_factor)

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


def trace_rays_plain(state0, spin, lam, eta, r_o=1000.0, tau_max=4.0,
                     n_fine=8192, ngeo=100, substeps=8, first_substeps=512,
                     r_stop_factor=1.05):
    """Both passes in torch ops, in the dtype and on the device of the
    inputs. Returns (tau_final (n,), samples): a dict of (ngeo, n) tensors
    u, c, phi, t, t_c, pm_r, pm_th."""
    tau_final = terminal_mino_time(state0, spin, lam, eta, r_o,
                                   tau_max=tau_max, n_fine=n_fine,
                                   r_stop_factor=r_stop_factor)
    samples = sample_rays(state0, tau_final, spin, lam, eta, r_o=r_o,
                          ngeo=ngeo, substeps=substeps,
                          first_substeps=first_substeps,
                          r_stop_factor=r_stop_factor)
    return tau_final, samples


SAMPLE_FIELDS = ('u', 'c', 'phi', 't', 't_c', 'pm_r', 'pm_th')
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load_library('geodesic_trace')
    lib.geodesic_trace.argtypes = ([_P] * 5 + [_I] + [_F] * 8 + [_I] * 4
                                   + [_P])
    lib.geodesic_trace.restype = _I
    lib.geodesic_trace_fields.restype = _I
    if lib.geodesic_trace_fields() != len(SAMPLE_FIELDS):
        raise RuntimeError('geodesic_trace.cu records other fields than '
                           'SAMPLE_FIELDS')
    return lib


@torch.no_grad()
def trace_rays(state0, spin, lam, eta, r_o=1000.0, tau_max=4.0, n_fine=8192,
               ngeo=100, substeps=8, first_substeps=512, r_stop_factor=1.05):
    """The float32 trace of `trace_rays_plain` as one launch of the CUDA
    kernel for tensors on the card; tensors on the CPU take the plain
    version (in their own dtype). state0 is `initial_state`'s RayState,
    lam and eta its (n,) constants. Returns (tau_final, samples) as
    `trace_rays_plain` does. `trace_rays.launches` counts the kernel's
    launches."""
    device = lam.device
    if device.type == 'cpu':
        return trace_rays_plain(state0, spin, lam, eta, r_o, tau_max, n_fine,
                                ngeo, substeps, first_substeps,
                                r_stop_factor)
    if device.type != 'cuda':
        raise ValueError(f'no geodesic kernel for device {device}')
    n = lam.shape[0]
    for x in (*state0, lam, eta):
        if x.device != device or x.dtype != torch.float32 \
                or x.shape != (n,) or not x.is_contiguous():
            raise ValueError('the geodesic kernel takes contiguous float32 '
                             '(n,) tensors on one CUDA device')
    if n == 0 or ngeo < 2 or min(n_fine, substeps, first_substeps) < 1:
        raise ValueError(f'nothing to trace: {n} rays, ngeo {ngeo}, n_fine '
                         f'{n_fine}, substeps {substeps}/{first_substeps}')
    u_clip, u_escape, u_floor = _stop_constants(spin, r_o, r_stop_factor)
    f32 = lambda x: float(np.float32(x))
    packed = torch.stack(tuple(state0))
    out = torch.empty((len(SAMPLE_FIELDS), ngeo, n), dtype=torch.float32,
                      device=device)
    tau_final = torch.empty(n, dtype=torch.float32, device=device)
    err = _lib().geodesic_trace(
        packed.data_ptr(), lam.data_ptr(), eta.data_ptr(), out.data_ptr(),
        tau_final.data_ptr(), n, f32(spin), f32(spin**2), f32(4.0 * spin**2),
        f32(u_clip), f32(u_escape), f32(u_floor), f32(tau_max / n_fine),
        f32(tau_max), n_fine, ngeo, substeps, first_substeps,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, 'geodesic_trace')
    trace_rays.launches += 1
    return tau_final, dict(zip(SAMPLE_FIELDS, out.unbind(0)))


trace_rays.launches = 0
