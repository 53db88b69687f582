"""Fused NeRF render: hand-written CUDA kernels, their plain versions, and
the autograd glue.

PyTorch counterpart of `bhnerf_tpu/ops/fused.py`. The training hot loop
evaluates velocity warp -> posenc -> MLP -> sigmoid -> mask on every
(sample, frame) column; the kernels in `csrc/fused_render.cu` run that
whole chain per tile of columns in shared memory, so the (columns, 128)
activations never round-trip through device memory:

* `render_fwd` replaces `_fwd_kernel` (reference fused.py:169) and, with
  `stash=True`, also writes the encoded features F for the backward;
* `render_bwd` replaces `_bwd_kernel` (reference fused.py:198): parameter
  gradients from the stashed (F, em), and with `want_dt` the per-frame
  t_eff cotangent that carries the learnable injection time.

Each wrapper runs its kernel for CUDA tensors (and raises if it cannot)
and its plain PyTorch version, the same math in the same order of
operations, for CPU tensors. `launches` on each wrapper counts kernel
launches. Layouts: coords (3, N), omega/tg/smask (1, N), t_eff (nt, 1),
emission (nt, N), F (feat, nt * N) with column t * N + n, weights as
nn.Linear's (out, in) with biases (out,).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from bhnerf_tpu_torch import emission as emission_lib
from bhnerf_tpu_torch.models.fields import (has_learned_injection,
                                            learned_t_injection, skip_after)
from bhnerf_tpu_torch.ops import _build

# sample-count multiple the kernels take (one tile of columns per block)
TILE_N = 64
# the kernels take MLP widths that are multiples of 16 up to MAX_WIDTH
# (one 16-row weight tile per warp), with width + padded features up to
# MAX_ROWS (tiles of the backward's W^T d_pre per warp)
MAX_WIDTH = 128
MAX_ROWS = 160


def pack_params(params):
    """The MLP of a NeRFParams module as ([W_i (out, in)], [b_i (out,)]).
    nn.Linear's (out, in) layout is what the kernels consume."""
    layers = params.mlp.layers
    return [l.weight for l in layers], [l.bias for l in layers]


def _round(x, bf16):
    """Round to the compute dtype and back (matmul operands in bf16)."""
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


# ---------------------------------------------------------------------------
# plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------
def _prologue_plain(t_eff, coords, omega, tg, smask, scale, deg, bf16):
    """Velocity warp + posenc for all frames, feature-major; mirrors the
    kernel's prologue (and reference fused.py:84-121). Returns
    (F (feat, nt * N) in the compute dtype, mask (nt, N))."""
    inv_scale = float(np.float32(1.0 / scale))
    t_M = t_eff + tg                                    # (nt, N)
    valid = t_M >= 0.0
    theta = torch.where(valid, t_M, torch.zeros_like(t_M)) * omega
    c, s = torch.cos(theta), torch.sin(theta)
    x, y, z = coords[0:1], coords[1:2], coords[2:3]
    vf = valid.to(torch.float32)
    w = torch.stack([(c * x + s * y) * vf * inv_scale,
                     (c * y - s * x) * vf * inv_scale,
                     z * vf * inv_scale])               # (3, nt, N)
    rows = [w]
    if deg > 0:
        # [w | sin(2^i w) | cos(2^i w)]: one sin/cos, then the
        # double-angle recursion (2sc, c^2 - s^2)
        s, c = torch.sin(w), torch.cos(w)
        sins, coss = [s], [c]
        for _ in range(1, deg):
            s, c = 2.0 * s * c, c * c - s * s
            sins.append(s)
            coss.append(c)
        rows = [w] + sins + coss
    F = torch.cat(rows, dim=0)
    return _round(F.reshape(F.shape[0], -1), bf16), vf * smask


def _forward_chain_plain(F, weights, biases, cfg, bf16):
    """Feature-major MLP; returns (post-relu activations, head output)."""
    depth, _, do_skip = cfg
    h = F
    acts = []
    for i in range(depth):
        inp = F if i == 0 else h
        h = _round(torch.relu(_round(weights[i], bf16) @ inp
                              + biases[i][:, None]), bf16)
        if skip_after(i, depth, do_skip):
            h = torch.cat([h, F], dim=0)
        acts.append(h)
    out = _round(weights[depth], bf16) @ h + biases[depth][:, None]
    return acts, out


def render_fwd_plain(t_eff, coords, omega, tg, smask, weights, biases, cfg,
                     scale, deg, compute_dtype='float32', stash=False):
    """Plain version of the forward kernel: emission (nt, N), plus the
    features F (feat, nt * N) when `stash`."""
    bf16 = compute_dtype == 'bfloat16'
    nt, n = t_eff.shape[0], coords.shape[1]
    F, mask = _prologue_plain(t_eff, coords, omega, tg, smask, scale, deg,
                              bf16)
    _, out = _forward_chain_plain(F, weights, biases, cfg, bf16)
    em = torch.sigmoid(out - 10.0).reshape(nt, n) * mask
    return (em, F) if stash else em


def render_bwd_plain(g_em, em, F, omega, weights, biases, cfg, deg,
                     compute_dtype='float32', want_dt=False):
    """Plain version of the backward kernel: ([dW_i], [db_i], d_t (nt, 1))
    from the stashed (F, em); mirrors reference fused.py:198-302."""
    bf16 = compute_dtype == 'bfloat16'
    depth, width, do_skip = cfg
    nt, n = g_em.shape
    acts, _ = _forward_chain_plain(F, weights, biases, cfg, bf16)
    d_out = _round((g_em * em * (1.0 - em)).reshape(1, -1), bf16)
    gw = [None] * (depth + 1)
    gb = [None] * (depth + 1)
    gw[depth] = d_out @ acts[-1].T
    gb[depth] = d_out.sum(dim=1)
    d_h = _round(weights[depth], bf16).T @ d_out
    d_F = None
    for i in range(depth - 1, -1, -1):
        relu_out = acts[i]
        if skip_after(i, depth, do_skip):
            if want_dt:
                d_F = d_h[width:] if d_F is None else d_F + d_h[width:]
            d_h = d_h[:width]
            relu_out = relu_out[:width]
        d_pre = _round(torch.where(relu_out > 0.0, d_h,
                                   torch.zeros_like(d_h)), bf16)
        inp = F if i == 0 else acts[i - 1]
        gw[i] = d_pre @ inp.T
        gb[i] = d_pre.sum(dim=1)
        if i > 0:
            d_h = _round(weights[i], bf16).T @ d_pre
        elif want_dt:
            dF0 = _round(weights[0], bf16).T @ d_pre
            d_F = dF0 if d_F is None else d_F + dF0

    if not want_dt:
        return gw, gb, torch.zeros((nt, 1), dtype=torch.float32,
                                   device=g_em.device)
    # posenc chain, then d theta = dw . dw/dtheta with dw/dtheta = (wy, -wx, 0)
    dw = d_F[0:3]
    for i in range(deg):
        s_rows = F[3 + 3 * i:6 + 3 * i]
        c_rows = F[3 + 3 * deg + 3 * i:6 + 3 * deg + 3 * i]
        ds = d_F[3 + 3 * i:6 + 3 * i]
        dc = d_F[3 + 3 * deg + 3 * i:6 + 3 * deg + 3 * i]
        dw = dw + (2.0 ** i) * (ds * c_rows - dc * s_rows)
    dtheta = dw[0] * F[1] - dw[1] * F[0]                # (nt * N,)
    d_t = (dtheta.reshape(nt, n) * omega).sum(dim=1, keepdim=True)
    return gw, gb, d_t


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load_library('fused_render')
    lib.fused_render_fwd.argtypes = [_P] * 9 + [_I] * 7 + [ctypes.c_float,
                                                           _I, _P]
    lib.fused_render_fwd.restype = _I
    lib.fused_render_bwd.argtypes = ([_P] * 7 + [_I] + [_P] * 3 + [_I] * 10
                                     + [_P])
    lib.fused_render_bwd.restype = _I
    lib.fused_render_bwd_smem.argtypes = [_I, _I, _I]
    lib.fused_render_bwd_smem.restype = ctypes.c_size_t
    lib.fused_render_n_params.argtypes = [_I] * 4
    lib.fused_render_n_params.restype = _I
    lib.fused_render_tile.restype = _I
    if lib.fused_render_tile() != TILE_N:
        raise RuntimeError('fused_render.cu tile differs from TILE_N')
    return lib


def _pad16(k):
    return -(-k // 16) * 16


def _check_cuda_inputs(tensors, cfg, feat, n):
    width = cfg[1]
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError('fused kernels take contiguous float32 tensors '
                             'on one CUDA device')
    if n % TILE_N:
        raise ValueError(f'sample count {n} must be a multiple of TILE_N '
                         f'({TILE_N}); pad the inputs')
    if width % 16 or width > MAX_WIDTH or width + _pad16(feat) > MAX_ROWS:
        raise ValueError(f'the fused CUDA kernels take net_width a multiple '
                         f'of 16 up to {MAX_WIDTH} with width + padded '
                         f'features <= {MAX_ROWS}; got width {width}, '
                         f'{feat} features')


def _pack_cuda(weights, biases, cfg, feat, bf16):
    """The kernels' parameter layout: every W_i (out, in) with `in`
    zero-padded to a multiple of 16, flat in layer order (rounded to bf16
    in bf16 mode), and the biases. Returns (w, b, n_params)."""
    w = torch.cat([torch.nn.functional.pad(
        _round(wi.detach().float(), bf16),
        (0, _pad16(wi.shape[1]) - wi.shape[1])).reshape(-1)
        for wi in weights])
    b = torch.cat([bi.detach().float().reshape(-1) for bi in biases])
    n_params = _lib().fused_render_n_params(cfg[0], cfg[1], feat,
                                            int(cfg[2]))
    if w.numel() + b.numel() != n_params:
        raise RuntimeError('parameter layout differs from fused_render.cu')
    return w, b, n_params


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def render_fwd(t_eff, coords, omega, tg, smask, weights, biases, cfg, scale,
               deg, compute_dtype='float32', stash=False):
    """Forward kernel (CUDA tensors) or its plain version (CPU tensors).
    Returns emission (nt, N), and F (feat, nt * N) with `stash`."""
    if coords.device.type == 'cpu':
        return render_fwd_plain(t_eff, coords, omega, tg, smask, weights,
                                biases, cfg, scale, deg, compute_dtype, stash)
    if coords.device.type != 'cuda':
        raise ValueError(f'no fused kernel for device {coords.device}')
    depth, width, do_skip = cfg
    nt, n = t_eff.shape[0], coords.shape[1]
    feat = 3 * (1 + 2 * deg)
    bf16 = compute_dtype == 'bfloat16'
    _check_cuda_inputs([t_eff, coords, omega, tg, smask], cfg, feat, n)
    w, b, _ = _pack_cuda(weights, biases, cfg, feat, bf16)
    em = torch.empty((nt, n), dtype=torch.float32, device=coords.device)
    f_store = (torch.empty((feat, nt * n), dtype=torch.float32,
                           device=coords.device) if stash else None)
    err = _lib().fused_render_fwd(
        _ptr(t_eff), _ptr(coords), _ptr(omega), _ptr(tg), _ptr(smask),
        _ptr(w), _ptr(b), _ptr(em), _ptr(f_store), nt, n, depth, width,
        feat, int(do_skip), deg, float(np.float32(1.0 / scale)), int(bf16),
        _stream(coords.device))
    _build.check(err, 'fused_render_fwd')
    render_fwd.launches += 1
    return (em, f_store) if stash else em


render_fwd.launches = 0


def render_bwd(g_em, em, f_store, omega, weights, biases, cfg, deg,
               compute_dtype='float32', want_dt=False):
    """Backward kernel (CUDA tensors) or its plain version (CPU tensors).
    Returns ([dW_i (out, in)], [db_i (out,)], d_t (nt, 1)).

    On the card the parameter gradients come from a persistent grid of one
    block per SM, each summing its tiles into a private partial, and a
    fixed-order sum of the partials: deterministic from run to run."""
    if g_em.device.type == 'cpu':
        return render_bwd_plain(g_em, em, f_store, omega, weights, biases,
                                cfg, deg, compute_dtype, want_dt)
    if g_em.device.type != 'cuda':
        raise ValueError(f'no fused kernel for device {g_em.device}')
    depth, width, do_skip = cfg
    nt, n = g_em.shape
    feat = f_store.shape[0]
    bf16 = compute_dtype == 'bfloat16'
    g_em = g_em.contiguous()
    _check_cuda_inputs([g_em, em, f_store, omega], cfg, feat, n)
    lib = _lib()
    smem = lib.fused_render_bwd_smem(depth, width, feat)
    props = torch.cuda.get_device_properties(g_em.device)
    limit = getattr(props, 'shared_memory_per_block_optin', 232448)
    if smem > limit:
        raise ValueError(f'fused backward needs {smem} B of shared memory '
                         f'per block (depth {depth}, width {width}); the '
                         f'card allows {limit}')
    w, b, n_params = _pack_cuda(weights, biases, cfg, feat, bf16)
    stride = -(-n_params // 8) * 8      # 32-byte aligned partial rows
    grid = min(props.multi_processor_count, nt * (n // TILE_N))
    dev = g_em.device
    partial = torch.zeros((grid, stride), dtype=torch.float32, device=dev)
    dt_partial = torch.zeros((grid, nt), dtype=torch.float32, device=dev)
    grads = torch.empty(n_params, dtype=torch.float32, device=dev)
    d_t = torch.empty((nt, 1), dtype=torch.float32, device=dev)
    err = lib.fused_render_bwd(
        _ptr(g_em), _ptr(em), _ptr(f_store), _ptr(omega), _ptr(w), _ptr(b),
        _ptr(partial), stride, _ptr(dt_partial), _ptr(grads), _ptr(d_t), nt,
        n, depth, width, feat, int(do_skip), deg, int(bf16), int(want_dt),
        grid, _stream(dev))
    _build.check(err, 'fused_render_bwd')
    render_bwd.launches += 1
    gw, gb, off = [], [], 0
    for wi in weights:
        out, k = wi.shape
        block = grads[off:off + out * _pad16(k)].view(out, _pad16(k))
        gw.append(block[:, :k].contiguous())
        off += out * _pad16(k)
    for bi in biases:
        gb.append(grads[off:off + bi.numel()].view(bi.shape))
        off += bi.numel()
    return gw, gb, d_t


render_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class _Spec(NamedTuple):
    cfg: tuple
    scale: float
    deg: int
    compute_dtype: str
    want_dt: bool
    n_zero: int       # leading tensors that get a zero cotangent


class _FusedRender(torch.autograd.Function):
    """The reference's custom VJP (fused_render/_fr_fwd/_fr_bwd,
    fused.py:462-536) as one autograd Function: the forward stashes F and
    the emission, the backward runs render_bwd. The frozen ray constants
    get zero cotangents, and so do the `n_zero` extra leaves (the
    learnable injection offset, whose gradient arrives through t_eff)."""

    @staticmethod
    def forward(ctx, spec, t_eff, coords, omega, tg, smask, *tensors):
        n_layers = spec.cfg[0] + 1
        weights = tensors[spec.n_zero:spec.n_zero + n_layers]
        biases = tensors[spec.n_zero + n_layers:]
        if not any(ctx.needs_input_grad):
            return render_fwd(t_eff, coords, omega, tg, smask, weights,
                              biases, spec.cfg, spec.scale, spec.deg,
                              spec.compute_dtype)
        em, f_store = render_fwd(t_eff, coords, omega, tg, smask, weights,
                                 biases, spec.cfg, spec.scale, spec.deg,
                                 spec.compute_dtype, stash=True)
        ctx.spec = spec
        ctx.frozen_shapes = [x.shape for x in (coords, omega, tg, smask)]
        ctx.save_for_backward(em, f_store, omega, *tensors)
        return em

    @staticmethod
    def backward(ctx, g_em):
        spec = ctx.spec
        em, f_store, omega, *tensors = ctx.saved_tensors
        n_layers = spec.cfg[0] + 1
        zero_leaves = tensors[:spec.n_zero]
        weights = tensors[spec.n_zero:spec.n_zero + n_layers]
        biases = tensors[spec.n_zero + n_layers:]
        gw, gb, d_t = render_bwd(g_em, em, f_store, omega, weights, biases,
                                 spec.cfg, spec.deg, spec.compute_dtype,
                                 want_dt=spec.want_dt)
        needs = ctx.needs_input_grad
        frozen = [torch.zeros(shape, dtype=torch.float32, device=g_em.device)
                  if needs[2 + k] else None
                  for k, shape in enumerate(ctx.frozen_shapes)]
        return (None, d_t if needs[1] else None, *frozen,
                *(torch.zeros_like(z) for z in zero_leaves), *gw, *gb)


def _mlp_leaves(params):
    """(weights, biases, zero-cotangent leaves) of a NeRFParams module.
    The fused gradient covers the MLP only; the learnable injection
    offset gets its gradient through t_eff, so its own cotangent is zero.
    Any other parameter would silently get a wrong zero gradient: refuse
    (reference fused.py:514-529)."""
    weights, biases = pack_params(params)
    mlp_ids = {id(p) for p in weights + biases}
    zero_leaves = []
    for name, p in params.named_parameters():
        if id(p) in mlp_ids:
            continue
        if name != 't_injection':
            raise ValueError(
                f'fused_render covers MLP parameters only; param leaf '
                f'{name!r} would receive a silent zero gradient - use the '
                f'plain path for this predictor')
        zero_leaves.append(p)
    return weights, biases, zero_leaves


def fused_render(params, coords, omega, tg, smask, t_eff, cfg, scale, deg,
                 compute_dtype='float32'):
    """Warp + posenc + MLP emission through the fused kernels.

    coords (3, N), omega/tg/smask (1, N) with N a multiple of TILE_N;
    t_eff (nt, 1) frame times in M units with t_injection subtracted.
    Returns emission (nt, N). Gradients flow to the MLP parameters and to
    t_eff (the learnable injection time); smask MUST be binary, because
    the backward rebuilds d_out = g * em * (1 - em) from the stored masked
    emission (reference fused.py:474-478).
    """
    if coords.shape[1] % TILE_N:
        raise ValueError(
            f'sample count {coords.shape[1]} must be a multiple of TILE_N '
            f'({TILE_N}); pad the inputs (see render_samples)')
    weights, biases, zero_leaves = _mlp_leaves(params)
    spec = _Spec(tuple(cfg), float(scale), int(deg), compute_dtype,
                 has_learned_injection(params), len(zero_leaves))
    return _FusedRender.apply(spec, t_eff, coords, omega, tg, smask,
                              *zero_leaves, *weights, *biases)


# ---------------------------------------------------------------------------
# integration with the training step
# ---------------------------------------------------------------------------
def _flatten_sample_args(coords, omega, tg, smask, n):
    """Flatten/pad per-sample constants into the kernel layout.

    coords: (3, ...) component-major; omega scalar or coords-shaped;
    tg/smask coords[0]-shaped. Padding columns get tg = -1e30 (never
    valid)."""
    n_pad = (n + TILE_N - 1) // TILE_N * TILE_N
    pad = n_pad - n
    dev = coords.device

    def row(x, fill=0.0):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        x = torch.broadcast_to(x, coords.shape[1:]).reshape(1, n)
        return torch.nn.functional.pad(x, (0, pad), value=fill)

    coords_n = torch.nn.functional.pad(
        coords.reshape(3, n).to(torch.float32), (0, pad))
    return (coords_n.contiguous(), row(omega), row(tg, fill=-1e30),
            row(smask), n_pad)


def render_samples(params, predictor, t_frames_M, coords, omega, tg,
                   t_injection, smask=1.0):
    """Emission on an arbitrary per-sample set via the fused kernels.
    Returns (nt_flat, n) with nt_flat = prod(shape(t_frames_M)) (>= 1)."""
    n = int(np.prod(coords.shape[1:]))
    coords_n, omega_n, tg_n, smask_n, _ = _flatten_sample_args(
        coords, omega, tg, smask, n)
    # t_injection may carry the learnable offset: the kernel's t_eff
    # cotangent composes with this subtraction
    t_eff = (torch.as_tensor(t_frames_M, dtype=torch.float32,
                             device=coords.device).reshape(-1, 1)
             - torch.as_tensor(t_injection, dtype=torch.float32,
                               device=coords.device))
    cfg = (predictor.net_depth, predictor.net_width, predictor.do_skip)
    em = fused_render(params, coords_n, omega_n, tg_n, smask_n,
                      t_eff.contiguous(), cfg, float(predictor.scale),
                      int(predictor.posenc_deg), predictor.compute_dtype)
    return em[:, :n]


def predict_emission_fused(params, predictor, t_frames_M, rt):
    """Drop-in replacement for train.step.predict_emission through the
    fused kernels. Returns emission shaped (nt, na, nb, ngeo)."""
    domain = emission_lib.domain_mask(rt.coords, predictor.rmin,
                                      predictor.rmax, predictor.z_width)
    em = render_samples(params, predictor, t_frames_M, rt.coords, rt.Omega,
                        rt.t_geos_rel,
                        learned_t_injection(params, rt.t_injection),
                        smask=domain.to(torch.float32))
    t_shape = np.shape(t_frames_M)
    return em.reshape(*t_shape, *rt.coords.shape[1:])
