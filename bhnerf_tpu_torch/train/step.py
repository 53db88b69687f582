"""Ray constants, domain compaction, image loss and the gradient step.

PyTorch counterpart of `bhnerf_tpu/train/step.py`:

* `RayTracingArgs` freezes the geodesic constants into float32 tensors on
  the training device; `t_geos - t_injection` is subtracted in float64 on
  the host before the cast, so the float32 tensors carry O(1..100) values
  instead of O(r_o) (reference step.py:87-88);
* `CompactRayArgs` keeps only the in-domain samples (~17% of them in the
  production configuration), built once on the host in one of two
  layouts. 'gather' packs the samples tight and the per-pixel reduction
  re-gathers them into groups of `_REDUCE_G` and sums (`_GroupedReduce`,
  whose backward is the gather adjoint). 'native' lays the samples
  directly into the per-pixel padded group slots, with inert filler
  samples in the empty slots, so the reduction is a strided sum with no
  gather (`_NativeReduce`);
* the sample-parallel layout (`compact_raytracing_args(mesh=...)`): the
  pixel-sorted in-domain samples split into equal contiguous blocks, one
  per rank of the mesh's 'ray' axis, each with its own block-local
  reduction tables; a rank renders and reduces its block and one
  all-reduce sums the partial images (`parallel.mesh.sum_partials`);
* polarized ray constants carry per-sample Stokes factors `J`; they fold
  into one weight row per Stokes component, outside the fused kernels;
* the 'lc' loss takes the lightcurve straight from the compact samples
  as `em @ weights^T`, sharing one emission pass with the aux images
  (a gradient step on samples split over a mesh sums only the
  lightcurve);
* the EHT losses (`loss_fn_eht`: 'vis', 'amp', 'cphase', 'bs', 'logcamp',
  'camp') map images to visibilities through a dense or factored DFT
  operator split into real and imaginary parts, whose products run in
  IEEE float32 whatever the caller's TF32 setting;
* `make_step_fns` returns the grad/test steps over full device-resident
  frame tensors plus explicit frame indices; under a mesh a gradient
  step takes this rank's share of the frame batch and sums the
  gradients over the ranks before Adam;
* `make_scan_step` and `make_composed_scan_step` run a chunk of gradient
  steps on frame indices drawn on the host and uploaded once, without a
  synchronisation inside the chunk beyond the collectives of a mesh; for
  an ensemble the host picks each step's variant from the list.
  `stack_ensemble` stacks an ensemble as the reference does, and raises
  as it does when the variants differ.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from bhnerf_tpu_torch import constants as consts
from bhnerf_tpu_torch import emission as emission_lib
from bhnerf_tpu_torch import tracing
from bhnerf_tpu_torch import units, utils
from bhnerf_tpu_torch.models.fields import learned_t_injection
from bhnerf_tpu_torch.ops import fused as fused_lib
from bhnerf_tpu_torch.ops import gr
from bhnerf_tpu_torch.parallel import mesh as mesh_lib

# group size of the two-level compact reduction
_REDUCE_G = 8


@dataclasses.dataclass
class RayTracingArgs:
    """Non-optimized ray-tracing constants for the training loop
    (reference network.py:850-894)."""

    coords: Any      # (3, na, nb, ngeo) f32
    Omega: Any       # scalar or (na, nb, ngeo)
    J: Any           # scalar intensity scale or (nstokes, na, nb, ngeo)
    g: Any           # (na, nb, ngeo) doppler
    dtau: Any        # (na, nb, ngeo)
    Sigma: Any       # (na, nb, ngeo)
    t_geos_rel: Any  # (na, nb, ngeo): t_geos - t_injection, O(1..100)
    t_injection: Any  # scalar f32 offset (0 unless learnable-injection)
    t_start_obs: float = 0.0   # in t_units
    t_to_M: float = 1.0        # multiply (t - t_start_obs) -> M units
    t_units: Any = None

    @property
    def num_stokes(self):
        return self.J.shape[0] if _ndim(self.J) > 0 else 1

    def frame_times_M(self, t_frames):
        """Observation times -> M units relative to t_start_obs."""
        return (t_frames - self.t_start_obs) * self.t_to_M


def _ndim(J):
    """Number of dimensions of a Stokes factor J. A scalar J may arrive as
    a float, a 0-d numpy array or a 0-d tensor (reference step.py:67,
    :279-287)."""
    return J.ndim if isinstance(J, torch.Tensor) else np.ndim(J)


@tracing.traced('bhnerf.precompute.ray_constants')
def raytracing_args(geos, Omega, t_injection, t_start_obs, J=1.0,
                    M=consts.sgra_mass, device='cuda', dtype=torch.float32):
    """Freeze geodesics into tensors on `device`
    (reference network.py:850-894). t_start_obs: units.Quantity or float
    hours. J: a scalar intensity scale, or per-sample Stokes factors
    (nstokes, na, nb, ngeo)."""
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
        J=float(J) if _ndim(J) == 0 else as_t(J),
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
    """Domain-compacted ray constants.

    Only the samples inside the supervised emission shell
    (rmin/rmax/z_width) are kept; images match RayTracingArgs up to float
    reassociation."""

    coords: Any        # (3, N_pad) in-domain sample positions
    Omega: Any         # scalar or (N_pad,)
    weights: Any       # (nstokes, N_pad) = J * g^2 * dtau * Sigma
    t_geos_rel: Any    # (N_pad,)
    pixel_ids: Any     # (N_pad,) int64; padding rows -> npix
    t_injection: Any   # scalar f32 offset
    # reduction layout: all three -> 'gather' (grouped reduction); only
    # red_group_ids -> 'native' (samples already sit in the k-major group
    # slots); none -> plain segment sum
    red_gather: Any = None     # (N_red,) int64 into the sample axis
    red_weights: Any = None    # (nstokes, N_red); 0 on filler slots
    red_group_ids: Any = None  # (N_red // G,) int64, sorted; pads -> npix
    image_shape: tuple = ()
    polarized: bool = False
    t_start_obs: float = 0.0
    t_to_M: float = 1.0
    t_units: Any = None
    # sample-parallel layout (compact_raytracing_args(mesh=...)): the
    # samples split into `num_shards` equal contiguous blocks over mesh
    # axis `shard_axis`; the tensors above hold this rank's block, with
    # block-local red_gather and global pixel ids
    num_shards: int = 1
    mesh: Any = None
    shard_axis: str = 'ray'

    @property
    def num_stokes(self):
        return self.weights.shape[0]

    @property
    def npix(self):
        return int(np.prod(self.image_shape))

    def frame_times_M(self, t_frames):
        return (t_frames - self.t_start_obs) * self.t_to_M


def _grouped_layout(pixel_ids, W, npix, G):
    """Grouped-reduction layout over one contiguous sample block
    (reference step.py:178-201): gather indices, weights with 0 on filler
    slots, the sorted pixel id of each group, and which slots hold a
    sample (groups not yet padded)."""
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
    return red_gather, red_weights, red_group_ids, valid_slot


def _pad_grouped(red_gather, red_weights, red_group_ids, valid_slot,
                 n_groups, npix, G):
    """Pad a grouped layout to exactly n_groups groups
    (reference step.py:204-219)."""
    g_pad = n_groups - red_group_ids.size
    if g_pad < 0:
        raise ValueError(f'layout has {red_group_ids.size} groups, more '
                         f'than the {n_groups} asked for')
    if g_pad:
        red_gather = np.concatenate(
            [red_gather, np.zeros(g_pad * G, np.int64)])
        red_weights = np.concatenate(
            [red_weights, np.zeros((red_weights.shape[0], g_pad * G),
                                   red_weights.dtype)], axis=1)
        red_group_ids = np.concatenate(
            [red_group_ids, np.full(g_pad, npix, np.int64)])
        valid_slot = np.concatenate(
            [valid_slot, np.zeros(g_pad * G, bool)])
    return red_gather, red_weights, red_group_ids, valid_slot


@tracing.traced('bhnerf.precompute.compaction')
def compact_raytracing_args(rt: RayTracingArgs, predictor, tile=None,
                            mesh=None, shards=None, shard_axis='ray',
                            pad_local_n=None, pad_groups=None,
                            layout='auto') -> CompactRayArgs:
    """Gather the in-domain subset of a RayTracingArgs (host-side, once).

    predictor supplies rmin/rmax/z_width; J/g/dtau/Sigma fold into one
    per-sample weight per Stokes component. The sample count is padded to
    `tile` (the fused kernels' TILE_N by default); padding samples never
    become valid.

    mesh + shard_axis (or an explicit shard count equal to that axis's
    size) give the sample-parallel layout (reference step.py:222-406):
    the pixel-sorted in-domain samples split into `shards` equal
    contiguous blocks (np.array_split), each with its own block-local
    grouped-reduction tables; all blocks share one sample count and one
    group count. Every rank builds every block's layout on the host, so
    that the padding is common, and keeps only the block of its
    coordinate along `shard_axis` on its device. shards > 1 without a
    mesh raises ValueError.

    pad_local_n / pad_groups force minimum per-block sample / group
    counts, so that several sub-pixel-ray variants come out identically
    shaped (compact_ensemble_args).

    layout selects the reduction strategy (reference step.py:249-258):
    * 'gather': samples packed tight; the reduce re-gathers them into
      per-pixel groups (red_gather/red_weights).
    * 'native': samples laid out directly in the per-pixel padded group
      slots (about a fifth of them inert filler that still goes through
      the MLP), so the reduce needs no gather and its backward gathers
      per group.
    * 'auto': 'gather' (the reference takes 'native' for multi-Stokes
      weights).
    """
    if tile is None:
        tile = fused_lib.TILE_N
    if shards is None:
        shards = mesh.shape.get(shard_axis, 1) if mesh is not None else 1
    if shards > 1 and mesh is None:
        raise ValueError('sample-parallel layout (shards > 1) needs the '
                         'mesh whose ranks hold the blocks')
    if mesh is not None and shards != mesh.shape.get(shard_axis, 1):
        raise ValueError(f'{shards} sample blocks over the {shard_axis!r} '
                         f'axis of a mesh of shape {mesh.shape}')
    block_index = 0 if mesh is None else int(mesh.coords[shard_axis])
    device = rt.coords.device
    host = lambda x: x.cpu().numpy()
    coords = host(rt.coords)                  # (3, na, nb, ngeo)
    na, nb, ngeo = coords.shape[1:]
    domain = emission_lib.domain_mask(
        torch.as_tensor(coords), predictor.rmin, predictor.rmax,
        predictor.z_width).numpy()

    flat_idx_all = np.flatnonzero(domain.reshape(-1))
    G = _REDUCE_G
    npix = na * nb
    w_all = (host(rt.g) ** 2 * host(rt.dtau)
             * host(rt.Sigma)).reshape(-1)[flat_idx_all]
    polarized = _ndim(rt.J) > 0
    if polarized:
        W_all = host(rt.J).reshape(rt.J.shape[0], -1)[:, flat_idx_all] \
            * w_all
    else:
        W_all = (w_all * float(rt.J))[None]

    # 'auto' is 'gather' on the card: the reference picks 'native' for
    # multi-Stokes weights because a gathered row costs the TPU ~15
    # cycles; on the H100 'native' spends more kernel time on its filler
    # than the gather costs
    if layout == 'auto':
        layout = 'gather'
    if layout not in ('native', 'gather'):
        raise ValueError(f'unknown layout {layout!r}')

    # contiguous equal blocks of the pixel-sorted sample list, so pixel
    # segments stay (mostly) block-local; the group count is common to
    # the blocks: a multiple of 8, and in the 'native' layout groups * G
    # is the sample count and must also be a multiple of the tile
    blocks = np.array_split(np.arange(flat_idx_all.size), shards)
    layouts = [_grouped_layout(flat_idx_all[b] // ngeo, W_all[:, b], npix, G)
               for b in blocks]
    n_groups = max(lay[2].size for lay in layouts)
    gmult = max(8, tile // G) if layout == 'native' else 8
    if pad_groups is not None:
        n_groups = max(n_groups, int(pad_groups))
    n_groups = (n_groups + gmult - 1) // gmult * gmult

    b = blocks[block_index]
    idx = flat_idx_all[b]
    rg, rw, rgid, valid = _pad_grouped(*layouts[block_index], n_groups,
                                       npix, G)
    Omega = rt.Omega
    omega_flat = None if Omega.ndim == 0 else host(Omega).reshape(-1)
    tg_flat = host(rt.t_geos_rel).reshape(-1)
    coords_flat = coords.reshape(3, -1)

    if layout == 'native':
        # samples live directly in the padded group slots: the reduce is
        # a strided sum with no gather; filler slots are inert (never
        # valid in time, zero weight). Slots are k-major (slot = k *
        # n_groups + g), the reference's order (step.py:327-350)
        def kmajor(a):
            return (a.reshape(*a.shape[:-1], n_groups, G)
                    .swapaxes(-1, -2).reshape(*a.shape[:-1], -1))

        slot_idx = idx[rg]
        cols = dict(
            coords=kmajor(np.where(valid[None], coords_flat[:, slot_idx],
                                   0.0)),
            Omega=(None if omega_flat is None else kmajor(
                np.where(valid, omega_flat[slot_idx], 0.0))),
            weights=kmajor(rw),
            tg=kmajor(np.where(valid, tg_flat[slot_idx], -1e30)),
            pix=np.tile(rgid, G))
        rg = rw = None
    else:
        local_n = max((len(blk) + tile - 1) // tile * tile for blk in blocks)
        if pad_local_n is not None:
            local_n = max(local_n, int(pad_local_n))
        pad = local_n - idx.size

        def padded(x, fill=0.0):
            return np.concatenate(
                [x, np.full((*x.shape[:-1], pad), fill, x.dtype)], axis=-1)

        cols = dict(
            coords=padded(coords_flat[:, idx]),
            Omega=None if omega_flat is None else padded(omega_flat[idx]),
            weights=padded(W_all[:, b]),
            # padding gets a never-valid time so it never activates
            tg=padded(tg_flat[idx], fill=-1e30),
            pix=padded((idx // ngeo).astype(np.int64), fill=npix))

    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(device)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64)).to(device)
    return CompactRayArgs(
        coords=f32(cols['coords']),
        Omega=Omega if omega_flat is None else f32(cols['Omega']),
        weights=f32(cols['weights']),
        t_geos_rel=f32(cols['tg']),
        pixel_ids=i64(cols['pix']),
        t_injection=rt.t_injection.clone(),
        red_gather=None if rg is None else i64(rg),
        red_weights=None if rw is None else f32(rw),
        red_group_ids=i64(rgid),
        image_shape=(na, nb),
        polarized=polarized,
        t_start_obs=rt.t_start_obs,
        t_to_M=rt.t_to_M,
        t_units=rt.t_units,
        num_shards=int(shards),
        mesh=mesh,
        shard_axis=shard_axis,
    )


def compact_ensemble_args(rt_list, predictor, **kwargs):
    """Domain-compact a sub-pixel-ray ensemble into identically shaped
    CompactRayArgs (reference step.py:411-437). Different sub-pixel
    offsets give different in-domain sample counts; every variant is
    padded to the ensemble's largest sample and group counts. Returns a
    list."""
    rt_list = list(rt_list) if isinstance(rt_list, (list, tuple)) \
        else [rt_list]
    built = [compact_raytracing_args(rt, predictor, **kwargs)
             for rt in rt_list]
    shape = lambda c: (c.coords.shape[-1], c.red_group_ids.shape[-1])
    if len({shape(c) for c in built}) > 1:
        # re-compact only the variants below the ensemble maximum (the
        # pads are lower bounds, so the largest are already final)
        ln = max(shape(c)[0] for c in built)
        ng = max(shape(c)[1] for c in built)
        built = [c if shape(c) == (ln, ng)
                 else compact_raytracing_args(rt, predictor, pad_local_n=ln,
                                              pad_groups=ng, **kwargs)
                 for c, rt in zip(built, rt_list)]
    return built


# the fields of the ray-constant dataclasses that stack along a variant
# axis (the reference's pytree leaves, step.py:50-52, 135-136); the others
# must agree across an ensemble
_LEAVES = {
    RayTracingArgs: ('coords', 'Omega', 'J', 'g', 'dtau', 'Sigma',
                     't_geos_rel', 't_injection'),
    CompactRayArgs: ('coords', 'Omega', 'weights', 't_geos_rel', 'pixel_ids',
                     't_injection', 'red_gather', 'red_weights',
                     'red_group_ids'),
}


def check_ensemble(rt_list):
    """Raises the ValueError of stack_ensemble when the variants of
    `rt_list` cannot be stacked, without stacking them; returns the
    stackable fields' names."""
    first = rt_list[0]
    leaves = []
    try:
        if any(type(rt) is not type(first) for rt in rt_list):
            raise ValueError('variants of different classes')
        for f in dataclasses.fields(first):
            xs = [getattr(rt, f.name) for rt in rt_list]
            if f.name not in _LEAVES[type(first)] or \
                    all(x is None for x in xs):
                if any(x != xs[0] for x in xs):
                    raise ValueError(f'{f.name} differs across variants')
                continue
            if any(x is None for x in xs):
                raise ValueError(f'{f.name} is None in some variants')
            if all(isinstance(x, torch.Tensor) for x in xs) and \
                    len({(x.shape, x.dtype, x.device) for x in xs}) > 1:
                raise ValueError(
                    f'{f.name} shapes {[tuple(x.shape) for x in xs]}')
            leaves.append(f.name)
    except (ValueError, TypeError, RuntimeError) as e:
        raise ValueError(
            f'ensemble variants are not uniformly shaped ({e}); build '
            f'compact ensembles with compact_ensemble_args') from e
    return leaves


def stack_ensemble(rt_list):
    """Stack identically shaped ray constants (dense or compact) into one
    object of the same class with a leading variant axis on every leaf
    (reference step.py:440-462). A single variant comes back as it is.
    Raises ValueError if the variants' shapes or static fields differ:
    build compact ensembles with compact_ensemble_args. The port's chunks
    need no stack (the host picks each step's variant from the list); the
    Optimizer only checks that one could be made (check_ensemble)."""
    rt_list = list(rt_list) if isinstance(rt_list, (list, tuple)) \
        else [rt_list]
    if len(rt_list) == 1:
        return rt_list[0]
    stacked = {}
    for name in check_ensemble(rt_list):
        xs = [getattr(rt, name) for rt in rt_list]
        # python scalars (a scalar J) stack into a host tensor
        stacked[name] = torch.stack(xs) if all(
            isinstance(x, torch.Tensor) for x in xs) else torch.as_tensor(
                np.asarray(xs, np.float64))
    return dataclasses.replace(rt_list[0], **stacked)


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


def _native_reduce_impl(npix, em, weights, group_ids):
    F, ns = em.shape[0], weights.shape[0]
    contrib = em[:, None, :] * weights               # (F, ns, N)
    # k-major slots: a group's elements are strided by n_groups
    gsum = contrib.reshape(F, ns, _REDUCE_G, -1).sum(2)
    out = torch.zeros((F, ns, npix + 1), dtype=em.dtype, device=em.device)
    out.index_add_(2, group_ids, gsum)
    return out[..., :npix]


class _NativeReduce(torch.autograd.Function):
    """Per-pixel weighted sums for the 'native' layout: strided group
    sums with no gather, then the small sorted scatter. The backward
    gathers d_img per group and broadcasts within the group (reference
    step.py:533-569)."""

    @staticmethod
    def forward(ctx, em, npix, weights, group_ids):
        ctx.save_for_backward(weights, group_ids)
        return _native_reduce_impl(npix, em, weights, group_ids)

    @staticmethod
    def backward(ctx, d_img):
        weights, group_ids = ctx.saved_tensors
        dpad = torch.nn.functional.pad(d_img, (0, 1))   # padding pixel
        dg = dpad.index_select(2, group_ids)            # (F, ns, n_groups)
        w4 = weights.reshape(weights.shape[0], _REDUCE_G, -1)
        d_em = torch.einsum('fsg,skg->fkg', dg, w4)
        return d_em.reshape(d_img.shape[0], -1), None, None, None


def _reduce_to_images(em, crt: CompactRayArgs):
    """Per-pixel weighted sums of compact samples: em (F, N) -> images
    (F, nstokes, npix), by the layout the args carry."""
    if crt.red_gather is None and crt.red_group_ids is None:
        return _segment_reduce(crt.npix, em, crt.pixel_ids, crt.weights)
    if crt.red_gather is None:
        return _NativeReduce.apply(em, crt.npix, crt.weights,
                                   crt.red_group_ids)
    return _GroupedReduce.apply(em, crt.npix, crt.red_gather,
                                crt.red_weights, crt.red_group_ids,
                                crt.pixel_ids, crt.weights)


def predict_emission(params, predictor, t_frames_M, rt: RayTracingArgs):
    """Velocity-warped emission along rays for a batch of frames (plain
    PyTorch)."""
    warped, valid = emission_lib.velocity_warp_coords(
        rt.coords, rt.Omega, t_frames_M, 0.0, rt.t_geos_rel,
        learned_t_injection(params, rt.t_injection), t_units=None,
        return_mask=True)
    return predictor.emission_at(params, warped, valid, rt.coords)


def _compact_emission(params, predictor, t_frames_M, crt: CompactRayArgs,
                      fused):
    """Per-sample emission over compact samples: (F, n) for flat frames."""
    n = crt.coords.shape[-1]
    t_shape = tuple(t_frames_M.shape)
    fused = fused and getattr(predictor, 'out_channel', 1) == 1
    if fused:
        em = fused_lib.render_samples(
            params, predictor, t_frames_M, crt.coords, crt.Omega,
            crt.t_geos_rel, learned_t_injection(params, crt.t_injection))
        emission = em.reshape(*t_shape, n)
    else:
        warped, valid = emission_lib.velocity_warp_coords(
            crt.coords, crt.Omega, t_frames_M, 0.0, crt.t_geos_rel,
            learned_t_injection(params, crt.t_injection), t_units=None,
            return_mask=True)
        warped = torch.broadcast_to(warped, (*t_shape, n, 3))
        valid = torch.broadcast_to(valid, (*t_shape, n))
        emission = predictor.emission_at(params, warped, valid, crt.coords)
    return emission.reshape(-1, n)


def _shape_images(images, t_shape, crt):
    images = images.reshape(*t_shape, crt.num_stokes, *crt.image_shape)
    if not crt.polarized:
        images = images[..., 0, :, :]
    return images


def _shape_lightcurve(lc, t_shape, crt):
    lc = lc.reshape(*t_shape, crt.num_stokes)
    return lc if crt.polarized else lc[..., 0]


def _frame_times(t_frames_M, rt):
    return torch.as_tensor(t_frames_M, dtype=torch.float32,
                           device=rt.coords.device)


def _sum_over_blocks(crt: CompactRayArgs, *parts, kind='image'):
    """The partial results of this rank's sample block summed over the
    blocks of a sample-parallel layout: one all-reduce over the mesh's
    `shard_axis` (reference step.py:623-677, the psum at the end of the
    shard_map), counted as `kind`; the parts themselves for one block."""
    if crt.mesh is None:
        return parts
    return mesh_lib.sum_partials(crt.mesh, crt.shard_axis, *parts,
                                 kind=kind)


def _compact_prediction(params, predictor, t_frames_M, crt: CompactRayArgs,
                        fused=False):
    """Image frames from domain-compacted samples: the rank's block
    rendered and reduced, then summed over the blocks."""
    emission = _compact_emission(params, predictor, t_frames_M, crt, fused)
    (images,) = _sum_over_blocks(crt, _reduce_to_images(emission, crt))
    return _shape_images(images, tuple(t_frames_M.shape), crt)


def compact_lightcurve(params, predictor, t_frames_M, crt: CompactRayArgs,
                       fused=False):
    """Lightcurve directly from compact samples: lc = em @ weights^T
    (reference step.py:703-730). The 'lc' loss sums the image over
    pixels, so the per-Stokes totals are one (F, N) @ (N, ns) product
    and the per-pixel reduction is not needed. For callers that never
    need images; loss_fn_image shares the pass with its aux images."""
    t_frames_M = _frame_times(t_frames_M, crt)
    em = _compact_emission(params, predictor, t_frames_M, crt, fused)
    (lc,) = _sum_over_blocks(crt, em @ crt.weights.T, kind='lightcurve')
    return _shape_lightcurve(lc, tuple(t_frames_M.shape), crt)


def _image_and_lightcurve(params, predictor, t_frames_M, crt, fused,
                          sum_images):
    t_frames_M = _frame_times(t_frames_M, crt)
    t_shape = tuple(t_frames_M.shape)
    em = _compact_emission(params, predictor, t_frames_M, crt, fused)
    if sum_images:
        images, lc = _sum_over_blocks(crt, _reduce_to_images(em, crt),
                                      em @ crt.weights.T)
    else:
        with torch.no_grad():
            images = _reduce_to_images(em, crt)
        (lc,) = _sum_over_blocks(crt, em @ crt.weights.T, kind='lightcurve')
    return (_shape_images(images, t_shape, crt),
            _shape_lightcurve(lc, t_shape, crt))


def compact_image_and_lightcurve(params, predictor, t_frames_M,
                                 crt: CompactRayArgs, fused=False):
    """(images, lightcurve) from one emission pass over compact samples
    (reference step.py:733-759): the lightcurve is em @ weights^T and the
    image reduce rides the same pass, so the fused forward runs once; in
    the sample-parallel layout both partials are summed in one
    all-reduce."""
    return _image_and_lightcurve(params, predictor, t_frames_M, crt, fused,
                                 sum_images=True)


def image_plane_prediction(params, predictor, t_frames_M, rt, fused=False):
    """Emission -> (polarized) image-plane frames (reference
    network.py:373-420). fused=True routes the render through the fused
    CUDA kernels; CompactRayArgs dispatch to the domain-compacted
    pipeline."""
    t_frames_M = _frame_times(t_frames_M, rt)
    if isinstance(rt, CompactRayArgs):
        return _compact_prediction(params, predictor, t_frames_M, rt,
                                   fused=fused)
    if fused and getattr(predictor, 'out_channel', 1) == 1:
        emission = fused_lib.predict_emission_fused(
            params, predictor, t_frames_M, rt)
    else:
        emission = predict_emission(params, predictor, t_frames_M, rt)
    emission = emission_lib.apply_stokes_factors(emission, rt.J)
    return gr.radiative_transfer(emission, rt.g, rt.dtau, rt.Sigma)


def loss_fn_image(params, predictor, target, sigma, offset, t_frames_M,
                  rt, scale, dtype, fused=False):
    """Chi-square image ('full') or lightcurve ('lc') loss (reference
    network.py:422-484). Returns (scale * loss, [images]).

    The 'lc' loss reads the lightcurve alone. So where autograd records
    (a gradient step) on samples split over a mesh, only the lightcurve
    is summed over the blocks (frames x Stokes floats, not the images'
    frames x Stokes x pixels) and the images returned are this rank's
    partials, detached; the reference's image psum has no reader there
    either, and XLA drops it inside its scan. Without autograd (a test
    step) the images and the lightcurve are summed in one all-reduce."""
    if dtype == 'full':
        images = image_plane_prediction(params, predictor, t_frames_M, rt,
                                        fused=fused)
        loss = torch.sum(torch.abs((images - target - offset) / sigma) ** 2)
    elif dtype == 'lc':
        if isinstance(rt, CompactRayArgs):
            # one product instead of the per-pixel reduce + pixel sum
            # (different only by float reassociation); the aux images
            # share the emission pass
            images, lightcurve = _image_and_lightcurve(
                params, predictor, t_frames_M, rt, fused,
                sum_images=rt.mesh is None or not torch.is_grad_enabled())
        else:
            images = image_plane_prediction(params, predictor, t_frames_M,
                                            rt, fused=fused)
            lightcurve = images.sum(dim=(-1, -2))
        loss = torch.sum(
            torch.abs((lightcurve - target - offset) / sigma) ** 2)
    else:
        raise ValueError(f'image dtype ({dtype}) not supported')
    return scale * loss, [images]


def to_real_measurements(dtype, target, sigma, A):
    """Split complex measurement operators into a real/imag layout
    (reference step.py:810-843; host numpy). Layouts consumed by
    loss_fn_eht:

    * 'vis':    target (..., 2, nvis) [re, im]; sigma broadcastable;
                A (..., 2, nvis, npix^2)
    * 'amp':    target (..., nvis) real; A (..., 2, nvis, npix^2)
    * 'cphase': target (..., ntri) radians; A (..., 3, 2, ntri, npix^2)
    * 'bs':     target (..., 2, ntri) [re, im]; sigma broadcastable;
                A (..., 3, 2, ntri, npix^2)
    * 'logcamp'/'camp': target (..., nquad) real; A
                (..., 4, 2, nquad, npix^2)

    Factored operators (observation.chisqdata(operator='factored')) are
    already real separable stacks (..., 4, n, npix) and pass through
    (apply_measurement_operator tells the forms apart by their shape).
    """
    A = np.asarray(A)
    if np.iscomplexobj(A):
        A_ri = np.stack([A.real, A.imag], axis=-3).astype(np.float32)
    else:
        A_ri = A.astype(np.float32)
    target = np.asarray(target)
    sigma = np.asarray(sigma, np.float32)
    if dtype in ('vis', 'bs'):
        target_ri = np.stack([target.real, target.imag],
                             axis=-2).astype(np.float32)
        sigma_ri = np.broadcast_to(sigma[..., None, :],
                                   target_ri.shape).copy()
        return np.nan_to_num(target_ri), sigma_ri, np.nan_to_num(A_ri)
    return (np.nan_to_num(np.asarray(target, np.float32)), sigma,
            np.nan_to_num(A_ri))


@contextlib.contextmanager
def _ieee_float32_matmul():
    """cuBLAS products in IEEE float32 inside the scope, whatever the
    caller set: TF32 keeps 10 mantissa bits, and a dense visibility sums
    npix^2 terms. The previous setting is restored exactly, so that a
    caller who set the legacy allow_tf32 flag can still read it (torch
    refuses to read it while the two settings disagree)."""
    mm = torch.backends.cuda.matmul
    prev = mm.fp32_precision
    mm.fp32_precision = 'ieee'
    try:
        yield
    finally:
        mm.fp32_precision = prev


def _is_dense(images, A):
    ny, nx = images.shape[-2], images.shape[-1]
    if A.shape[-1] == ny * nx and A.shape[-3] != 4:
        return True
    if A.shape[-3] != 4 or A.shape[-1] < max(nx, ny):
        raise ValueError(
            f'measurement operator shape {tuple(A.shape)} matches neither '
            f'the dense (..., 2, n, {ny * nx}) nor the factored (..., 4, n, '
            f'>=max(nx, ny)) layout for image shape {tuple(images.shape)}')
    return False


def _factors(A, nx, ny):
    return (A[..., 0, :, :nx], A[..., 1, :, :nx], A[..., 2, :, :ny],
            A[..., 3, :, :ny])


class _OperatorProduct(torch.autograd.Function):
    """images (..., ny, nx) -> visibilities (..., 2, n), and the adjoint
    for the images' gradient (A is data, never differentiated); both
    under _ieee_float32_matmul."""

    @staticmethod
    def forward(ctx, images, A):
        ctx.save_for_backward(A)
        ctx.image_shape = images.shape
        ctx.dense = _is_dense(images, A)
        ny, nx = images.shape[-2], images.shape[-1]
        with _ieee_float32_matmul():
            if ctx.dense:
                x = utils.expand_dims(
                    images.reshape(*images.shape[:-2], -1, 1), A.ndim,
                    axis=-3)
                ctx.operand_shape = x.shape
                return torch.matmul(A, x).squeeze(-1)
            imgs = utils.expand_dims(images, A.ndim - 1, axis=-3)
            ctx.operand_shape = imgs.shape
            cu, su, cv, sv = _factors(A, nx, ny)
            tc = torch.einsum('...yx,...kx->...ky', imgs, cu)
            ts = torch.einsum('...yx,...kx->...ky', imgs, su)
            re = torch.sum(cv * tc - sv * ts, dim=-1)
            im = -torch.sum(sv * tc + cv * ts, dim=-1)
            return torch.stack([re, im], dim=-2)

    @staticmethod
    def backward(ctx, g):
        (A,) = ctx.saved_tensors
        shape = ctx.image_shape
        ny, nx = shape[-2], shape[-1]
        with _ieee_float32_matmul():
            if ctx.dense:
                d = torch.matmul(A.transpose(-1, -2), g.unsqueeze(-1))
            else:
                cu, su, cv, sv = _factors(A, nx, ny)
                g_re, g_im = g[..., 0, :, None], g[..., 1, :, None]
                d_tc = cv * g_re - sv * g_im           # (..., n, ny)
                d_ts = -(sv * g_re + cv * g_im)
                d = (torch.einsum('...ky,...kx->...yx', d_tc, cu)
                     + torch.einsum('...ky,...kx->...yx', d_ts, su))
        return d.sum_to_size(ctx.operand_shape).reshape(shape), None


def apply_measurement_operator(images, A):
    """images (..., ny, nx) -> visibilities (..., 2, n) [re, im]
    (reference step.py:846-882). Two operator forms, told apart by their
    shape:

    * dense (..., 2, n, ny*nx): one batched matmul against vec(image)
      (the re/im rows of the complex DTFT matrix);
    * factored (..., 4, n, npix) [Cu, Su, Cv, Sv]: the separable type-3
      DFT (observation.dft_factors) as two real products contracting the
      image's x axis, then an elementwise combine and the y sum:
          V = sum_y (Cv - i Sv) * (Tc - i Ts),   T* = I @ {Cu,Su}^T
      Rectangular images: Cu/Su carry nx columns and Cv/Sv ny, zero-padded
      to max(nx, ny) in the stack, sliced back out here.

    The products run in IEEE float32 whatever
    torch.backends.cuda.matmul's TF32 setting is, forward and backward.
    Raises ValueError for an operator shape that fits neither form.
    """
    return _OperatorProduct.apply(images, A)


def loss_fn_eht(params, predictor, target, sigma, A, t_frames_M, rt, scale,
                dtype, fused=False):
    """Chi-square losses on interferometric data (reference
    step.py:885-942, network.py:486-564): 'vis', 'amp', 'cphase', 'bs',
    'logcamp', 'camp'. A: per-frame operators in the layouts of
    to_real_measurements; everything stays real. Padded rows (A = 0,
    sigma = inf) add exactly zero to the loss and a finite zero to the
    gradient. Returns (scale * chisq, [images])."""
    images = image_plane_prediction(params, predictor, t_frames_M, rt,
                                    fused=fused)
    vis_ri = apply_measurement_operator(images, A)
    if dtype == 'vis':
        # vis_ri, target: (..., 2, nvis)
        chisq = torch.sum(((vis_ri - target) / sigma) ** 2)
    elif dtype == 'amp':
        amp = torch.sqrt(vis_ri[..., 0, :] ** 2 + vis_ri[..., 1, :] ** 2
                         + 1e-30)
        chisq = torch.sum(((amp - target) / sigma) ** 2)
    elif dtype in ('cphase', 'bs'):
        # vis_ri: (..., 3, 2, ntri): the complex triple product in reals
        re0, im0 = vis_ri[..., 0, 0, :], vis_ri[..., 0, 1, :]
        re1, im1 = vis_ri[..., 1, 0, :], vis_ri[..., 1, 1, :]
        re2, im2 = vis_ri[..., 2, 0, :], vis_ri[..., 2, 1, :]
        re01 = re0 * re1 - im0 * im1
        im01 = re0 * im1 + im0 * re1
        re = re01 * re2 - im01 * im2
        im = re01 * im2 + im01 * re2
        if dtype == 'bs':
            # padded rows have sigma = inf: both components add zero
            bs_ri = torch.stack([re, im], dim=-2)
            return scale * torch.sum(((bs_ri - target) / sigma) ** 2), \
                [images]
        # padded triangle rows have A = 0, so (re, im) = (0, 0), where
        # atan2's backward is NaN even under a zero cotangent (sigma =
        # inf): the double where keeps padding at exactly zero
        safe = (re * re + im * im) > 1e-30
        clphase = torch.atan2(torch.where(safe, im, 0.0),
                              torch.where(safe, re, 1.0))
        chisq = torch.sum(torch.where(
            safe, (1.0 - torch.cos(target - clphase)) / sigma ** 2, 0.0))
    elif dtype in ('logcamp', 'camp'):
        # vis_ri: (..., 4, 2, nquad): per-leg visibilities, numerator legs
        # (0, 1), denominator legs (2, 3)
        amp2 = vis_ri[..., 0, :] ** 2 + vis_ri[..., 1, :] ** 2
        # padded quadrangles have A = 0, so amp2 = 0, where log's backward
        # is inf even under a zero cotangent (sigma = inf): double where
        safe = torch.amin(amp2, dim=-2) > 1e-30
        amp2 = torch.where(safe[..., None, :], amp2, 1.0)
        lca = 0.5 * (torch.log(amp2[..., 0, :]) + torch.log(amp2[..., 1, :])
                     - torch.log(amp2[..., 2, :])
                     - torch.log(amp2[..., 3, :]))
        model = torch.exp(lca) if dtype == 'camp' else lca
        chisq = torch.sum(torch.where(
            safe, ((model - target) / sigma) ** 2, 0.0))
    else:
        raise ValueError(f'eht dtype ({dtype}) not supported')
    return scale * chisq, [images]


def tv_loss(params, predictor, fov, resolution=32):
    """Finite-difference total variation of the emission field on a voxel
    grid of the canonical (t = 0) frame: one batched forward evaluation
    (reference step.py:945-962)."""
    p0 = next(params.parameters())
    grid = torch.linspace(-fov / 2, fov / 2, resolution, dtype=p0.dtype,
                          device=p0.device)
    coords = torch.stack(torch.meshgrid(grid, grid, grid, indexing='ij'))
    pts = torch.movedim(coords, 0, -1)
    valid = torch.ones(pts.shape[:-1], dtype=torch.bool, device=p0.device)
    em = predictor.emission_at(params, pts, valid, coords)
    h = fov / (resolution - 1)
    tv = sum(torch.mean(torch.abs(torch.diff(em, dim=a))) for a in range(3))
    return tv / h


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def _partial_axes(rt, mesh):
    """(mesh, axes) of a gradient step: the mesh the step runs on and the
    axes along which its ranks hold different partials of the loss. The
    frames are split over 'data' when the step was built with a mesh
    whose 'data' size is > 1; the samples over the ray constants'
    `shard_axis` when they are in the sample-parallel layout. Ranks that
    differ along no such axis compute the same thing."""
    rt_mesh = getattr(rt, 'mesh', None)
    if rt_mesh is not None and mesh is not None and rt_mesh is not mesh:
        raise ValueError('the ray constants and the frame batches are on '
                         'different meshes')
    axes = []
    if mesh is not None and mesh.shape.get('data', 1) > 1:
        axes.append('data')
    if rt_mesh is not None and rt.num_shards > 1:
        if rt.shard_axis in axes:
            raise ValueError(f'frames and samples both split over '
                             f'{rt.shard_axis!r}')
        axes.append(rt.shard_axis)
    return (rt_mesh if rt_mesh is not None else mesh), tuple(axes)


def make_step_fns(predictor, kind='image', dtype='full', fused=False,
                  tv_scale=0.0, tv_fov=None, tv_resolution=32, mesh=None):
    """(grad_step, test_step), equivalent to the reference's
    make_step_fns(gather=True): batch args are the FULL frame tensors
    (target, sigma, third, t_frames) on the device plus an `indices`
    tensor; the frame batch is selected inside the step. The third is
    `offset` for kind='image' and the measurement operator `A` for
    kind='eht'. Both return (loss, state, images); grad_step updates
    `state` in place. tv_scale > 0 adds tv_scale * tv_loss over a cube of
    side tv_fov (2 * predictor.scale by default).

    mesh: frame data-parallelism. Every rank passes the same indices and
    a gradient step renders this rank's contiguous share of them by its
    'data' coordinate (mesh_lib.batch_share: the 'data' size must divide
    the batch), then sums the gradients over the ranks that hold
    different partials (mesh_lib.all_reduce_gradients: frames over
    'data', and samples over 'ray' when the ray constants are in the
    sample-parallel layout) and the loss over 'data', so that every rank
    takes the same Adam step and returns the global loss; its images are
    those of this rank's frames (for the 'lc' loss on samples split over
    'ray', this rank's partial images: see loss_fn_image). The total
    variation depends only on the
    parameters and every rank computes it whole: its gradient is added
    on the first rank of those groups alone, and its value to the global
    loss once. A test step renders the whole batch on every rank."""
    if kind not in ('image', 'eht'):
        raise ValueError(f'unknown loss kind {kind!r}')
    loss_fn = loss_fn_image if kind == 'image' else loss_fn_eht

    def compute_batch_loss(params, target, sigma, third, t_frames, indices,
                           rt, scale):
        """(data loss, tv term or None, [images])."""
        take = lambda x: x.index_select(0, indices)
        t_frames_M = rt.frame_times_M(take(t_frames))
        loss, aux = loss_fn(params, predictor, take(target), take(sigma),
                            take(third), t_frames_M, rt, scale, dtype,
                            fused=fused)
        tv = None
        if tv_scale:
            fov = 2.0 * predictor.scale if tv_fov is None else tv_fov
            tv = tv_scale * tv_loss(params, predictor, fov, tv_resolution)
        return loss, tv, aux

    def grad_step(state, target, sigma, third, t_frames, indices, rt,
                  scale):
        on, axes = _partial_axes(rt, mesh)
        if 'data' in axes:
            indices = mesh_lib.batch_share(indices, on)
        with tracing.span('bhnerf.step.zero_grad'):
            state.zero_grad()
        with tracing.span('bhnerf.step.forward'):
            loss, tv, [images] = compute_batch_loss(
                state.params, target, sigma, third, t_frames, indices, rt,
                scale)
        # the tv gradient counts once across the ranks summed below
        first = on is None or all(on.coords[a] == 0 for a in axes)
        with tracing.span('bhnerf.step.backward'):
            (loss if tv is None or not first else loss + tv).backward()
        loss = loss.detach()
        if axes:
            with tracing.span('bhnerf.step.allreduce'):
                mesh_lib.all_reduce_gradients(state.params, on, axes)
                if 'data' in axes:
                    on.all_reduce(loss, ('data',), 'loss')
        with tracing.span('bhnerf.step.update'):
            state.apply_gradients()
        if tv is not None:
            loss = loss + tv.detach()
        return loss, state, images.detach()

    @torch.no_grad()
    def test_step(state, target, sigma, third, t_frames, indices, rt,
                  scale):
        loss, tv, [images] = compute_batch_loss(
            state.params, target, sigma, third, t_frames, indices, rt, scale)
        return (loss if tv is None else loss + tv), state, images

    return grad_step, test_step


def _check_chunk(indices, variants, batchsize, chunk, rt_list):
    """Shapes only: reading the tensor's values would synchronise."""
    if tuple(indices.shape) != (chunk, batchsize):
        raise ValueError(f'indices of shape {tuple(indices.shape)}; the chunk '
                         f'takes ({chunk}, {batchsize})')
    if len(variants) != chunk:
        raise ValueError(f'{len(variants)} variants for a chunk of {chunk}')
    if any(not 0 <= v < len(rt_list) for v in variants):
        raise ValueError(f'variant numbers {sorted(set(variants))} over '
                         f'{len(rt_list)} set(s) of ray constants')


def _chunk(state, grad_steps, scales, loss_args, indices, variants, rt,
           batchsize, chunk):
    """`chunk` gradient steps; step i applies each loss's gradient in turn
    on frames indices[i] and variant variants[i] of `rt` (one set of ray
    constants or a list of variants). Returns (state, the steps' summed
    losses (chunk,) on the device)."""
    rt_list = list(rt) if isinstance(rt, (list, tuple)) else [rt]
    _check_chunk(indices, variants, batchsize, chunk, rt_list)
    losses = []
    for i, v in enumerate(variants):
        total = 0.0
        for grad_step, args, scale in zip(grad_steps, loss_args, scales):
            loss, state, _ = grad_step(state, *args, indices[i], rt_list[v],
                                       scale)
            total = total + loss
        losses.append(total)
    return state, torch.stack(losses)


def make_scan_step(predictor, kind='image', dtype='full', fused=False,
                   tv_scale=0.0, tv_fov=None, tv_resolution=32, batchsize=6,
                   chunk=100, mesh=None):
    """`chunk` gradient steps of one loss in one call (reference
    step.py:1064-1126, a lax.scan there). Returns
    scan_steps(state, target, sigma, third, t_frames, indices, variants,
    rt, scale) -> (state, losses (chunk,) on the device).

    The frame batches are drawn on the host: `indices` is a (chunk,
    batchsize) int64 tensor already on the device, `variants` the chunk's
    variant numbers as host ints, and `rt` one set of ray constants (all
    variants 0) or an ensemble's list of them, of which step i trains on
    rt[variants[i]]. Each step is make_step_fns' grad_step (with its
    `mesh`), so a chunk gives the per-step loop's losses for the same
    draws. Inside the chunk nothing is read back, copied from the host or
    synchronised, beyond a mesh's collectives."""
    grad_step, _ = make_step_fns(predictor, kind=kind, dtype=dtype,
                                 fused=fused, tv_scale=tv_scale,
                                 tv_fov=tv_fov, tv_resolution=tv_resolution,
                                 mesh=mesh)

    def scan_steps(state, target, sigma, third, t_frames, indices, variants,
                   rt, scale):
        return _chunk(state, [grad_step], [scale],
                      [(target, sigma, third, t_frames)], indices, variants,
                      rt, batchsize, chunk)

    return scan_steps


def make_composed_scan_step(batchsize=6, chunk=100, metas=(), scales=()):
    """Chunked training of a `+`-composed TrainStep (reference
    step.py:1128-1207). metas: one dict per loss, the keyword arguments
    that loss would pass to make_scan_step (a TrainStep's scan_metas). As
    in the per-step loop, each step draws one frame batch and variant
    shared by every loss and applies each loss's gradient in composition
    order; the step's loss is their sum. Returns scan_steps(state,
    *loss_args, indices, variants, rt) -> (state, losses (chunk,)),
    loss_args the (target, sigma, third, t_frames) of each loss in order,
    and the rest as make_scan_step takes them."""
    metas = [dict(m) for m in metas]
    if len(scales) != len(metas):
        raise ValueError('need one scale per loss')
    grad_steps = [make_step_fns(
        m['predictor'], kind=m.get('kind', 'image'), dtype=m['dtype'],
        fused=m.get('fused', False), tv_scale=m.get('tv_scale', 0.0),
        tv_fov=m.get('tv_fov'), tv_resolution=m.get('tv_resolution', 32),
        mesh=m.get('mesh'))[0] for m in metas]

    def scan_steps(state, *args):
        *loss_args, indices, variants, rt = args
        if len(loss_args) != 4 * len(grad_steps):
            raise ValueError(f'{len(loss_args)} frame tensors for '
                             f'{len(grad_steps)} losses; each takes 4')
        return _chunk(state, grad_steps, scales,
                      [loss_args[4 * k:4 * k + 4]
                       for k in range(len(grad_steps))],
                      indices, variants, rt, batchsize, chunk)

    return scan_steps
