"""Geodesics container + image-plane tracing.

PyTorch counterpart of `bhnerf_tpu/geodesics/dataset.py`. Geodesic tables
are a once-per-configuration precompute: by default on the host in
float64, as in the reference, or with backend='device' in float32 on the
card by the tracer kernel (`integrator.trace_rays`); the training that
consumes them runs on the GPU. The container keeps host numpy leaves and
writes the same npz format as the reference (`save`/`load`), so tables
cross between the two packages.

Array layout matches the reference: (num_alpha, num_beta, ngeo).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bhnerf_tpu_torch import tracing
from bhnerf_tpu_torch.geodesics import integrator, kerr


@dataclasses.dataclass(frozen=True)
class Geodesics:
    """Bundle of ray samples + conserved quantities for one image plane."""

    # per-sample arrays, shape (num_alpha, num_beta, ngeo)
    r: np.ndarray
    theta: np.ndarray
    phi: np.ndarray
    t: np.ndarray
    mino: np.ndarray
    dtau: np.ndarray
    pm_r: np.ndarray          # sign of (forward) radial momentum
    pm_th: np.ndarray         # sign of (forward) polar momentum
    # per-pixel arrays, shape (num_alpha, num_beta)
    alpha: np.ndarray
    beta: np.ndarray
    lam: np.ndarray
    eta: np.ndarray
    tau_final: np.ndarray
    # scalars
    spin: float
    inc: float
    M: float = 1.0
    E: float = 1.0
    r_o: float = 1000.0

    _FIELDS = ('r', 'theta', 'phi', 't', 'mino', 'dtau', 'pm_r', 'pm_th',
               'alpha', 'beta', 'lam', 'eta', 'tau_final')
    _AUX = ('spin', 'inc', 'M', 'E', 'r_o')

    @property
    def num_alpha(self):
        return self.r.shape[0]

    @property
    def num_beta(self):
        return self.r.shape[1]

    @property
    def ngeo(self):
        return self.r.shape[2]

    @property
    def npix(self):
        return self.num_alpha * self.num_beta

    # cartesian coordinates (reference emission.py:271)
    @property
    def x(self):
        return self.r * np.sin(self.theta) * np.cos(self.phi)

    @property
    def y(self):
        return self.r * np.sin(self.theta) * np.sin(self.phi)

    @property
    def z(self):
        return self.r * np.cos(self.theta)

    # metric functions and potentials, numpy, by the formulas of kerr.py
    @property
    def Sigma(self):
        return kerr.Sigma(self.r, self.theta, self.spin)

    @property
    def Delta(self):
        return kerr.Delta(self.r, self.spin)

    @property
    def Xi(self):
        return kerr.Xi(self.r, self.theta, self.spin)

    @property
    def omega(self):
        """Frame-dragging angular velocity of the zero-angular-momentum
        observers."""
        return kerr.omega(self.r, self.theta, self.spin)

    @property
    def R(self):
        return kerr.R_potential(self.r, self.spin, self.lam[..., None],
                                self.eta[..., None])

    @property
    def Theta(self):
        return kerr.Theta_potential(self.theta, self.spin,
                                    self.lam[..., None], self.eta[..., None])

    @property
    def affine(self):
        """Affine parameter: cumulative trapezoid of Sigma over Mino time."""
        sig = self.Sigma
        dm = np.diff(self.mino, axis=-1)
        seg = 0.5 * (sig[..., 1:] + sig[..., :-1]) * dm
        return np.concatenate(
            [np.zeros_like(sig[..., :1]), np.cumsum(seg, axis=-1)], axis=-1)

    @property
    def coords(self):
        """Stacked [x, y, z] (axis 0), the NeRF sampling coordinates."""
        return np.stack([self.x, self.y, self.z], axis=0)

    def fillna(self, value=0.0):
        """xarray-API parity (reference dataset.py:147); the tracer produces
        no NaNs."""
        return self

    def save(self, path):
        """Serialize to .npz (the reference's format, dataset.py:151-156)."""
        arrays = {f: np.asarray(getattr(self, f)) for f in self._FIELDS}
        np.savez_compressed(path, **arrays,
                            _aux=np.array([getattr(self, f)
                                           for f in self._AUX]))

    @classmethod
    def load(cls, path):
        blob = np.load(path)
        aux = blob['_aux']
        return cls(*(blob[f] for f in cls._FIELDS),
                   **dict(zip(cls._AUX, (float(a) for a in aux))))

    def keplerian_omega(self, direction=1.0, frac=1.0):
        """Keplerian angular velocity field along the rays
        (reference alma.py:49)."""
        return kerr.keplerian_omega(self.r, self.spin, self.M, direction,
                                    frac)


def subpixel_jittered_axes(alpha_range, beta_range, num_alpha, num_beta,
                           rng):
    """One sub-pixel-randomized draw of the screen grid axes: per-axis
    uniform jitter within a pixel (reference kgeo.py:51-55). `rng` is a
    np.random.Generator; the alpha draw comes first, then the beta draw,
    so a seed gives the grid that the JAX package draws from it."""
    alpha_1d = np.linspace(*alpha_range, num_alpha)
    beta_1d = np.linspace(*beta_range, num_beta)
    psize_alpha = (alpha_range[1] - alpha_range[0]) / (num_alpha - 1)
    psize_beta = (beta_range[1] - beta_range[0]) / (num_beta - 1)
    alpha_1d = alpha_1d + (rng.random(num_alpha) - 0.5) * psize_alpha
    beta_1d = beta_1d + (rng.random(num_beta) - 0.5) * psize_beta
    return alpha_1d, beta_1d


def image_plane_geos(spin, inclination, alpha_range, beta_range, ngeo=100,
                     num_alpha=64, num_beta=64, distance=1000.0, E=1.0, M=1.0,
                     randomize_subpixel_rays=False, rng=None, tau_max=4.0,
                     n_fine=8192, substeps=8, dtype=None, backend='cpu',
                     mesh=None, verbose=False, device='cuda') -> Geodesics:
    """Trace Kerr geodesics for an image-plane grid (reference
    bhnerf/kgeo.py:6-63, bhnerf_tpu/geodesics/dataset.py:218-241): on the
    host in float64 by default, or in float32 on `device` with
    backend='device' (see trace_geodesics). With randomize_subpixel_rays
    the grid axes are jittered within a pixel from `rng` (a
    np.random.Generator; a fresh one when None). `verbose` is accepted
    for the reference's signature and ignored."""
    del verbose
    if randomize_subpixel_rays:
        rng = np.random.default_rng() if rng is None else rng
        alpha_1d, beta_1d = subpixel_jittered_axes(
            alpha_range, beta_range, num_alpha, num_beta, rng)
    else:
        alpha_1d = np.linspace(*alpha_range, num_alpha)
        beta_1d = np.linspace(*beta_range, num_beta)
    alpha, beta = np.meshgrid(alpha_1d, beta_1d, indexing='ij')
    return trace_geodesics(alpha, beta, spin, inclination, ngeo=ngeo,
                           distance=distance, E=E, M=M, tau_max=tau_max,
                           n_fine=n_fine, substeps=substeps, dtype=dtype,
                           backend=backend, mesh=mesh, device=device)


@tracing.traced('bhnerf.precompute.geodesics')
def trace_geodesics(alpha, beta, spin, inclination, ngeo=100, distance=1000.0,
                    E=1.0, M=1.0, tau_max=4.0, n_fine=8192, substeps=8,
                    dtype=None, backend='cpu', mesh=None,
                    device='cuda') -> Geodesics:
    """Trace geodesics for arbitrary (alpha, beta) screen points; alpha/beta
    may be any (matching) shape and output arrays get a trailing ngeo axis
    (reference dataset.py:244-365).

    backend='cpu' (the default) traces on the host in `dtype` (float64
    unless given), the reference's precision contract for tables.
    backend='device' traces in float32 on `device`, which only this
    backend reads: on a CUDA device one launch of the tracer kernel
    (`integrator.trace_rays`), on 'cpu' its plain float32 version. The
    float32 trace follows the float64 one to ~1e-4 relative in r and
    ~1e-3 M in t at the 90th percentile; near-critical rays diverge in
    their far field (r >> fov), outside the emission domain that consumers
    keep (tests/test_geodesics.py:318-402 holds the reference to the same
    bars). As in the reference, r, theta and phi come out in the trace
    dtype, t = t - t_c folded in float64 on the host, and alpha, beta,
    lam, eta and tau_final in the trace dtype. Every ray is independent,
    so the rays are traced as given (no padding).

    mesh (parallel.mesh.Mesh, backend='device' only; reference
    dataset.py:289-305): the flat ray list is padded with copies of its
    last ray to a multiple of the mesh's size, each rank launches the
    tracer on its contiguous block alone, and the table is assembled on
    every rank by one all-reduce of zeroed full-size buffers that hold
    each rank's block (adding zeros is exact, so the result is bitwise
    the concatenation of the blocks). One thread traces one ray, so the
    kernel's table equals the one-process trace bitwise; the plain
    version on the CPU may differ in the last bits, its vectorised
    arithmetic depending on the block's length."""
    if not 0.0 <= spin < 1.0:
        raise ValueError(f'spin must be in [0, 1), got {spin}')
    if not (E == 1.0 and M == 1.0):
        # rays are integrated in G = c = M = E = 1 units; physical mass
        # scaling enters through constants.GM_c3 time units
        raise ValueError(
            f'geodesics are traced in M=E=1 units (got M={M}, E={E}); '
            f'scale times/lengths via constants.GM_c3 / GM_c2')
    if backend not in ('cpu', 'device'):
        raise ValueError(f"backend must be 'cpu' or 'device', got "
                         f'{backend!r}')
    if backend == 'device':
        if dtype is not None and np.dtype(dtype) == np.float64:
            raise ValueError(
                "backend='device' traces in float32; drop the dtype "
                "argument or use backend='cpu' for the float64 host trace")
        dtype = np.float32
    elif dtype is None:
        dtype = np.float64
    dtype = np.dtype(dtype)
    if mesh is not None and backend != 'device':
        raise ValueError("mesh-sharded tracing requires backend='device' "
                         '(the host float64 trace is one process)')

    # exactly polar observers hit the phi coordinate singularity; nudge
    # off the axis (physically indistinguishable at 1e-6 rad)
    inclination = float(np.clip(inclination, 1e-6, np.pi - 1e-6))
    shape = np.shape(alpha)
    alpha_flat = np.ravel(np.asarray(alpha, dtype))
    beta_flat = np.ravel(np.asarray(beta, dtype))

    npix = alpha_flat.size
    if mesh is not None and npix % mesh.size:
        fill = np.full(mesh.size - npix % mesh.size, -1)
        alpha_flat = np.concatenate([alpha_flat, alpha_flat[fill]])
        beta_flat = np.concatenate([beta_flat, beta_flat[fill]])
    state0, lam, eta = integrator.initial_state(
        alpha_flat, beta_flat, spin, inclination, distance,
        torch.float32 if dtype == np.float32 else torch.float64)
    on = torch.device(device if backend == 'device' else 'cpu')
    trace = lambda rays: integrator.trace_rays(
        integrator.RayState(*(x[rays].to(on) for x in state0)), spin,
        lam[rays].to(on), eta[rays].to(on), r_o=distance, tau_max=tau_max,
        n_fine=n_fine, ngeo=ngeo, substeps=substeps)
    if mesh is None:
        tau_final, samples = trace(slice(None))
    else:
        tau_final, samples = _trace_sharded(trace, lam.shape[0], ngeo, mesh,
                                            on)
    samples = {k: v[:, :npix].cpu().numpy() for k, v in samples.items()}
    tau_final = tau_final[:npix].cpu().numpy()
    lam, eta = lam[:npix].numpy(), eta[:npix].numpy()
    alpha_flat, beta_flat = alpha_flat[:npix], beta_flat[:npix]

    def per_sample(arr):
        # (ngeo, npix) -> (*shape, ngeo)
        return np.moveaxis(arr, 0, -1).reshape(*shape, ngeo)

    r = per_sample(1.0 / samples['u'])
    theta = per_sample(np.arccos(np.clip(samples['c'], -1.0, 1.0)))
    phi = per_sample(samples['phi'])
    # fold the integrator's running Kahan error back in, in float64: for
    # the float32 trace this recovers the low bits of the one quantity
    # that grows to O(r_o) while downstream needs O(1) differences
    t = per_sample(samples['t'].astype(np.float64)
                   - samples['t_c'].astype(np.float64))
    pm_r = per_sample(samples['pm_r'])
    pm_th = per_sample(samples['pm_th'])

    tau_final = tau_final.reshape(shape)
    h = tau_final / (ngeo - 1)
    mino = h[..., None] * np.arange(ngeo)
    dtau = np.broadcast_to(h[..., None], mino.shape).copy()

    return Geodesics(
        r=r, theta=theta, phi=phi, t=t, mino=mino, dtau=dtau,
        pm_r=pm_r, pm_th=pm_th,
        alpha=alpha_flat.reshape(shape), beta=beta_flat.reshape(shape),
        lam=lam.reshape(shape), eta=eta.reshape(shape),
        tau_final=tau_final,
        spin=float(spin), inc=float(inclination), M=float(M), E=float(E),
        r_o=float(distance))


def _trace_sharded(trace, n, ngeo, mesh, device):
    """`trace` (rays -> (tau_final, samples)) over this rank's contiguous
    block of the n rays, then the whole table on every rank: each rank
    writes its block into a zeroed full-size buffer and one all-reduce
    sums them (rule 1 of the mesh's collectives: all_reduce and
    broadcast only, so gloo and NCCL alike)."""
    per = n // mesh.size
    lo = mesh.rank * per
    tau_b, samples_b = trace(slice(lo, lo + per))
    names = list(samples_b)
    full = torch.zeros((len(names) * ngeo + 1, n), dtype=tau_b.dtype,
                       device=device)
    full[:-1, lo:lo + per] = torch.cat([samples_b[k] for k in names])
    full[-1, lo:lo + per] = tau_b
    mesh.all_reduce(full, mesh.axis_names, 'trace')
    samples = dict(zip(names, full[:-1].reshape(len(names), ngeo, n)))
    return full[-1], samples
