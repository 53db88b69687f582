"""Ray constants, domain compaction, image loss and the gradient step.

PyTorch counterpart of the main-path subset of
`bhnerf_tpu/train/step.py`:

* `RayTracingArgs` freezes the geodesic constants into float32 tensors on
  the training device; `t_geos - t_injection` is subtracted in float64 on
  the host before the cast, so the float32 tensors carry O(1..100) values
  instead of O(r_o) (reference step.py:87-88);
* `CompactRayArgs` keeps only the in-domain samples (~17% of them in the
  production configuration) in the 'gather' layout, built once on the
  host; the per-pixel reduction re-gathers them into groups of
  `_REDUCE_G` and sums (`_GroupedReduce`, whose backward is the gather
  adjoint);
* `make_step_fns` returns the grad/test steps over full device-resident
  frame tensors plus explicit frame indices.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from bhnerf_tpu_torch import constants as consts
from bhnerf_tpu_torch import emission as emission_lib
from bhnerf_tpu_torch import units
from bhnerf_tpu_torch.models.fields import learned_t_injection
from bhnerf_tpu_torch.ops import fused as fused_lib
from bhnerf_tpu_torch.ops import gr

# group size of the two-level compact reduction
_REDUCE_G = 8


@dataclasses.dataclass
class RayTracingArgs:
    """Non-optimized ray-tracing constants for the training loop
    (reference network.py:850-894)."""

    coords: Any      # (3, na, nb, ngeo) f32
    Omega: Any       # scalar or (na, nb, ngeo)
    J: float         # intensity scale (single Stokes component)
    g: Any           # (na, nb, ngeo) doppler
    dtau: Any        # (na, nb, ngeo)
    Sigma: Any       # (na, nb, ngeo)
    t_geos_rel: Any  # (na, nb, ngeo): t_geos - t_injection, O(1..100)
    t_injection: Any  # scalar f32 offset (0 unless learnable-injection)
    t_start_obs: float = 0.0   # in t_units
    t_to_M: float = 1.0        # multiply (t - t_start_obs) -> M units
    t_units: Any = None

    def frame_times_M(self, t_frames):
        """Observation times -> M units relative to t_start_obs."""
        return (t_frames - self.t_start_obs) * self.t_to_M


def raytracing_args(geos, Omega, t_injection, t_start_obs, J=1.0,
                    M=consts.sgra_mass, device='cuda', dtype=torch.float32):
    """Freeze geodesics into tensors on `device`
    (reference network.py:850-894). t_start_obs: units.Quantity or float
    hours. J: a scalar intensity scale (polarized Stokes factors are not
    ported yet)."""
    if not np.isscalar(J):
        raise NotImplementedError('polarized (per-sample J) transport is '
                                  'not ported yet')
    umu = gr.azimuthal_velocity_vector(geos, np.asarray(Omega))
    g = gr.doppler_factor(geos, umu)

    t_value, t_unit = units.strip_time(t_start_obs)
    GM_c3 = consts.GM_c3(M).to(t_unit.name if t_unit else 'hr').value

    # f64 host subtraction before the f32 cast
    t_geos_rel = np.asarray(geos.t, np.float64) - float(t_injection)

    def as_t(x):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    return RayTracingArgs(
        coords=as_t(np.stack([geos.x, geos.y, geos.z], axis=0)),
        Omega=as_t(Omega),
        J=float(J),
        g=as_t(g),
        dtau=as_t(geos.dtau),
        Sigma=as_t(geos.Sigma),
        t_geos_rel=as_t(t_geos_rel),
        t_injection=torch.zeros((), dtype=dtype, device=device),
        t_start_obs=float(t_value),
        t_to_M=float(1.0 / GM_c3),
        t_units=t_unit,
    )


@dataclasses.dataclass
class CompactRayArgs:
    """Domain-compacted ray constants in the 'gather' layout.

    Only the samples inside the supervised emission shell
    (rmin/rmax/z_width) are kept; images match RayTracingArgs up to float
    reassociation."""

    coords: Any        # (3, N_pad) in-domain sample positions
    Omega: Any         # scalar or (N_pad,)
    weights: Any       # (1, N_pad) = J * g^2 * dtau * Sigma
    t_geos_rel: Any    # (N_pad,)
    pixel_ids: Any     # (N_pad,) int64, sorted; padding rows -> npix
    t_injection: Any   # scalar f32 offset
    # grouped-reduction layout; None -> plain segment sum
    red_gather: Any = None     # (N_red,) int64 into the sample axis
    red_weights: Any = None    # (1, N_red); 0 on filler slots
    red_group_ids: Any = None  # (N_red // G,) int64, sorted; pads -> npix
    image_shape: tuple = ()
    t_start_obs: float = 0.0
    t_to_M: float = 1.0
    t_units: Any = None

    @property
    def npix(self):
        return int(np.prod(self.image_shape))

    def frame_times_M(self, t_frames):
        return (t_frames - self.t_start_obs) * self.t_to_M


def _grouped_layout(pixel_ids, W, npix, G):
    """Grouped-reduction layout over one contiguous sample block
    (reference step.py:178-201): gather indices, weights with 0 on filler
    slots, and the sorted pixel id of each group."""
    counts = np.bincount(pixel_ids, minlength=npix)
    nz = np.flatnonzero(counts)
    c_nz = counts[nz]
    seg_starts = np.concatenate([[0], np.cumsum(c_nz)])[:-1]
    ng = -(-c_nz // G)                       # groups per pixel
    slots_per_pix = ng * G
    tot_slots = int(slots_per_pix.sum())
    pix_of_slot = np.repeat(np.arange(nz.size), slots_per_pix)
    slot_off = np.concatenate([[0], np.cumsum(slots_per_pix)])[:-1]
    slot_in_pix = np.arange(tot_slots) - slot_off[pix_of_slot]
    valid_slot = slot_in_pix < c_nz[pix_of_slot]
    red_gather = np.where(valid_slot,
                          seg_starts[pix_of_slot] + slot_in_pix, 0)
    red_weights = np.where(valid_slot[None], W[:, red_gather], 0.0)
    red_group_ids = np.repeat(nz, ng)
    return red_gather, red_weights, red_group_ids


def compact_raytracing_args(rt: RayTracingArgs,
                            predictor) -> CompactRayArgs:
    """Gather the in-domain subset of a RayTracingArgs (host-side, once)
    in the reference's single-device 'gather' layout.

    predictor supplies rmin/rmax/z_width; J/g/dtau/Sigma fold into one
    per-sample weight. The sample count is padded to the fused kernels'
    TILE_N; padding samples never become valid.
    """
    tile = fused_lib.TILE_N
    device = rt.coords.device
    coords = rt.coords.cpu().numpy()          # (3, na, nb, ngeo)
    na, nb, ngeo = coords.shape[1:]
    domain = emission_lib.domain_mask(
        torch.as_tensor(coords), predictor.rmin, predictor.rmax,
        predictor.z_width).numpy()

    idx = np.flatnonzero(domain.reshape(-1))
    G = _REDUCE_G
    npix = na * nb
    host = lambda x: x.cpu().numpy()
    w_all = (host(rt.g) ** 2 * host(rt.dtau)
             * host(rt.Sigma)).reshape(-1)[idx]
    W_all = (w_all * rt.J)[None]

    pix = idx // ngeo
    red_gather, red_weights, red_group_ids = _grouped_layout(
        pix, W_all, npix, G)
    # group count padded to a multiple of 8 (reference step.py:305-308)
    n_groups = (red_group_ids.size + 7) // 8 * 8
    g_pad = n_groups - red_group_ids.size
    red_gather = np.concatenate([red_gather, np.zeros(g_pad * G, np.int64)])
    red_weights = np.concatenate(
        [red_weights, np.zeros((red_weights.shape[0], g_pad * G))], axis=1)
    red_group_ids = np.concatenate([red_group_ids,
                                    np.full(g_pad, npix, np.int64)])
    local_n = (idx.size + tile - 1) // tile * tile
    pad = local_n - idx.size

    def padded(x, fill=0.0):
        return np.concatenate(
            [x, np.full((*x.shape[:-1], pad), fill, x.dtype)], axis=-1)

    Omega = rt.Omega
    omega_flat = None if Omega.ndim == 0 else host(Omega).reshape(-1)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(device)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64)).to(device)
    return CompactRayArgs(
        coords=f32(padded(coords.reshape(3, -1)[:, idx])),
        Omega=(Omega if omega_flat is None else f32(padded(omega_flat[idx]))),
        weights=f32(padded(W_all)),
        # padding gets a never-valid time so it never activates
        t_geos_rel=f32(padded(host(rt.t_geos_rel).reshape(-1)[idx],
                              fill=-1e30)),
        pixel_ids=i64(padded(pix.astype(np.int64), fill=npix)),
        t_injection=rt.t_injection.clone(),
        red_gather=i64(red_gather),
        red_weights=f32(red_weights),
        red_group_ids=i64(red_group_ids),
        image_shape=(na, nb),
        t_start_obs=rt.t_start_obs,
        t_to_M=rt.t_to_M,
        t_units=rt.t_units,
    )


# ---------------------------------------------------------------------------
# forward + losses
# ---------------------------------------------------------------------------
def _grouped_reduce_impl(npix, em, red_gather, red_weights, red_group_ids):
    F, ns = em.shape[0], red_weights.shape[0]
    emg = em.index_select(1, red_gather)             # (F, N_red)
    contrib = emg[:, None, :] * red_weights          # (F, ns, N_red)
    gsum = contrib.reshape(F, ns, -1, _REDUCE_G).sum(-1)
    out = torch.zeros((F, ns, npix + 1), dtype=em.dtype, device=em.device)
    out.index_add_(2, red_group_ids, gsum)
    return out[..., :npix]


class _GroupedReduce(torch.autograd.Function):
    """Per-pixel weighted sums through the grouped layout; the backward
    is the exact gather adjoint d_em[i] = sum_s d_img[s, pixel_ids[i]] *
    weights[s, i] (reference step.py:505-530)."""

    @staticmethod
    def forward(ctx, em, npix, red_gather, red_weights, red_group_ids,
                pixel_ids, weights):
        ctx.save_for_backward(pixel_ids, weights)
        return _grouped_reduce_impl(npix, em, red_gather, red_weights,
                                    red_group_ids)

    @staticmethod
    def backward(ctx, d_img):
        pixel_ids, weights = ctx.saved_tensors
        dpad = torch.nn.functional.pad(d_img, (0, 1))   # padding pixel
        d_em = torch.einsum('fsn,sn->fn', dpad.index_select(2, pixel_ids),
                            weights)
        return d_em, None, None, None, None, None, None


def _segment_reduce(npix, em, pixel_ids, weights):
    """Plain per-pixel segment sum (reference step.py:478-484)."""
    contrib = em[:, None, :] * weights               # (F, ns, N)
    out = torch.zeros((*contrib.shape[:2], npix + 1), dtype=em.dtype,
                      device=em.device)
    return out.index_add(2, pixel_ids, contrib)[..., :npix]


def _reduce_to_images(em, crt: CompactRayArgs):
    """em (F, N) -> images (F, 1, npix)."""
    if crt.red_gather is None:
        return _segment_reduce(crt.npix, em, crt.pixel_ids, crt.weights)
    return _GroupedReduce.apply(em, crt.npix, crt.red_gather,
                                crt.red_weights, crt.red_group_ids,
                                crt.pixel_ids, crt.weights)


def predict_emission(params, predictor, t_frames_M, rt: RayTracingArgs):
    """Velocity-warped emission along rays for a batch of frames (plain
    PyTorch)."""
    warped, valid = emission_lib.velocity_warp_coords(
        rt.coords, rt.Omega, t_frames_M, 0.0, rt.t_geos_rel,
        learned_t_injection(params, rt.t_injection), t_units=None)
    return predictor.emission_at(params, warped, valid, rt.coords)


def _compact_emission(params, predictor, t_frames_M, crt: CompactRayArgs,
                      fused):
    """Per-sample emission over compact samples: (F, n) for flat frames."""
    n = crt.coords.shape[-1]
    t_shape = tuple(t_frames_M.shape)
    fused = fused and predictor.out_channel == 1
    if fused:
        em = fused_lib.render_samples(
            params, predictor, t_frames_M, crt.coords, crt.Omega,
            crt.t_geos_rel, learned_t_injection(params, crt.t_injection))
        emission = em.reshape(*t_shape, n)
    else:
        warped, valid = emission_lib.velocity_warp_coords(
            crt.coords, crt.Omega, t_frames_M, 0.0, crt.t_geos_rel,
            learned_t_injection(params, crt.t_injection), t_units=None)
        warped = torch.broadcast_to(warped, (*t_shape, n, 3))
        valid = torch.broadcast_to(valid, (*t_shape, n))
        emission = predictor.emission_at(params, warped, valid, crt.coords)
    return emission.reshape(-1, n)


def _compact_prediction(params, predictor, t_frames_M, crt: CompactRayArgs,
                        fused=False):
    """Image frames from domain-compacted samples."""
    t_shape = tuple(t_frames_M.shape)
    emission = _compact_emission(params, predictor, t_frames_M, crt, fused)
    images = _reduce_to_images(emission, crt)
    return images.reshape(*t_shape, *crt.image_shape)


def image_plane_prediction(params, predictor, t_frames_M, rt, fused=False):
    """Emission -> image-plane frames (reference network.py:373-420).
    fused=True routes the render through the fused CUDA kernels;
    CompactRayArgs dispatch to the domain-compacted pipeline."""
    t_frames_M = torch.as_tensor(t_frames_M, dtype=torch.float32,
                                 device=rt.coords.device)
    if isinstance(rt, CompactRayArgs):
        return _compact_prediction(params, predictor, t_frames_M, rt,
                                   fused=fused)
    if fused and predictor.out_channel == 1:
        emission = fused_lib.predict_emission_fused(
            params, predictor, t_frames_M, rt)
    else:
        emission = predict_emission(params, predictor, t_frames_M, rt)
    if rt.J != 1.0:
        emission = emission * rt.J
    return gr.radiative_transfer(emission, rt.g, rt.dtau, rt.Sigma)


def loss_fn_image(params, predictor, target, sigma, offset, t_frames_M,
                  rt, scale, dtype, fused=False):
    """Chi-square image loss (reference network.py:422-484); only the
    'full' image loss is ported."""
    if dtype != 'full':
        raise NotImplementedError(f'image loss dtype {dtype!r} is not '
                                  f"ported; use 'full'")
    images = image_plane_prediction(params, predictor, t_frames_M, rt,
                                    fused=fused)
    loss = torch.sum(torch.abs((images - target - offset) / sigma) ** 2)
    return scale * loss, [images]


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def make_step_fns(predictor, dtype='full', fused=False):
    """(grad_step, test_step) for the image loss, equivalent to the
    reference's make_step_fns(kind='image', gather=True): batch args are
    the FULL frame tensors (target, sigma, offset, t_frames) on the
    device plus an `indices` tensor; the frame batch is selected inside
    the step. Both return (loss, state, images); grad_step updates
    `state` in place."""

    def compute_batch_loss(params, target, sigma, third, t_frames, indices,
                           rt, scale):
        take = lambda x: x.index_select(0, indices)
        t_frames_M = rt.frame_times_M(take(t_frames))
        return loss_fn_image(params, predictor, take(target), take(sigma),
                             take(third), t_frames_M, rt, scale, dtype,
                             fused=fused)

    def grad_step(state, target, sigma, third, t_frames, indices, rt,
                  scale):
        state.zero_grad()
        loss, [images] = compute_batch_loss(state.params, target, sigma,
                                            third, t_frames, indices, rt,
                                            scale)
        loss.backward()
        state.apply_gradients()
        return loss.detach(), state, images.detach()

    @torch.no_grad()
    def test_step(state, target, sigma, third, t_frames, indices, rt,
                  scale):
        loss, [images] = compute_batch_loss(state.params, target, sigma,
                                            third, t_frames, indices, rt,
                                            scale)
        return loss, state, images

    return grad_step, test_step
