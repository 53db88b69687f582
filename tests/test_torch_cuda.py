"""The port's CUDA kernels against their plain versions, on the card.

These tests import no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which configures JAX.) Without a
CUDA device each test skips itself.
"""
import json

import numpy as np
import pytest
import torch

from bhnerf_tpu_torch import emission, units
from bhnerf_tpu_torch.geodesics import image_plane_geos
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.ops import fused
from bhnerf_tpu_torch.train import step


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels run only on the card)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype,width,depth,nt,n_tiles', [
    ('float32', 128, 4, 3, 4), ('bfloat16', 128, 4, 3, 4),
    # narrower than the 32 padded feature rows of the skip input
    ('float32', 16, 4, 3, 4),
    # other skip positions: after layer 1 of 2, after layer 4 of 8
    ('float32', 128, 2, 3, 4), ('float32', 64, 8, 3, 4),
    ('bfloat16', 64, 8, 3, 4),
    # width 64, and 48, which leaves half of a warp's last 32-row unit
    # of output empty
    ('float32', 64, 4, 3, 4), ('float32', 48, 4, 3, 4),
    # fewer tiles than SMs: one frame, one tile
    ('float32', 128, 4, 1, 1)])
def test_kernels_match_plain_on_card(cuda_device, compute_dtype, width,
                                     depth, nt, n_tiles):
    """Forward and backward kernels against their plain versions on the
    same card inputs: emission atol 2e-6 / rtol 1e-4 (f32), gradients
    atol 5e-5 after normalising by the max, d_t rtol 2e-3; the backward
    bitwise equal on a repeated call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    n, deg = n_tiles * fused.TILE_N, 3
    pred = NeRFPredictor(scale=8.0, net_depth=depth, net_width=width,
                         posenc_deg=deg, compute_dtype=compute_dtype)
    params = pred.init_params(generator=torch.Generator().manual_seed(0),
                              device=cuda_device)
    weights, biases = [w.detach() for w in fused.pack_params(params)[0]], \
        [b.detach() + 0.3 for b in fused.pack_params(params)[1]]
    put = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(
        cuda_device).contiguous()
    t_eff = put(rng.uniform(0, 50, (nt, 1)))
    coords = put(rng.uniform(-8, 8, (3, n)))
    omega = put(rng.uniform(0.01, 0.1, (1, n)))
    tg = put(rng.uniform(-30, 30, (1, n)))
    smask = put(rng.random((1, n)) > 0.2)
    cfg = (depth, width, True)
    args = (t_eff, coords, omega, tg, smask, weights, biases, cfg, 8.0, deg,
            compute_dtype)
    em_k, f_k = fused.render_fwd(*args, stash=True)
    em_p, f_p = fused.render_fwd_plain(*args, stash=True)
    torch.cuda.synchronize()
    tol = dict(atol=2e-6, rtol=1e-4) if compute_dtype == 'float32' \
        else dict(atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(em_k.cpu().numpy(), em_p.cpu().numpy(), **tol)
    g = put(rng.standard_normal((nt, n)))
    # bf16: a cotangent that lands on a rounding boundary may round to the
    # neighbouring bf16 value in one version and not the other, so the
    # gradients are held to a normalised 1e-2 instead
    gtol = 5e-5 if compute_dtype == 'float32' else 1e-2
    for want_dt in (False, True):
        gk = fused.render_bwd(g, em_p, f_p, omega, weights, biases, cfg, deg,
                              compute_dtype, want_dt)
        gp = fused.render_bwd_plain(g, em_p, f_p, omega, weights, biases,
                                    cfg, deg, compute_dtype, want_dt)
        torch.cuda.synchronize()
        for a, b in zip(gp[0] + gp[1], gk[0] + gk[1]):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            scale = np.abs(a).max() + 1e-8
            np.testing.assert_allclose(b / scale, a / scale, atol=gtol)
        if want_dt and compute_dtype == 'float32':
            np.testing.assert_allclose(gk[2].cpu().numpy(),
                                       gp[2].cpu().numpy(), rtol=2e-3,
                                       atol=1e-6)
        again = fused.render_bwd(g, em_p, f_p, omega, weights, biases, cfg,
                                 deg, compute_dtype, want_dt)
        assert all(torch.equal(a, b) for a, b in
                   zip(gk[0] + gk[1] + [gk[2]], again[0] + again[1]
                       + [again[2]]))


def _forward_inputs(device, rng, width, depth, nt, n, compute_dtype, deg=3):
    pred = NeRFPredictor(scale=8.0, net_depth=depth, net_width=width,
                         posenc_deg=deg, compute_dtype=compute_dtype)
    params = pred.init_params(generator=torch.Generator().manual_seed(0),
                              device=device)
    weights, biases = [w.detach() for w in fused.pack_params(params)[0]], \
        [b.detach() + 0.3 for b in fused.pack_params(params)[1]]
    # lift the head so the emission is macroscopic
    biases[-1] = biases[-1] + 8.0
    put = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(
        device).contiguous()
    return (put(rng.uniform(0, 50, (nt, 1))), put(rng.uniform(-8, 8, (3, n))),
            put(rng.uniform(0.01, 0.1, (1, n))),
            put(rng.uniform(-30, 30, (1, n))), put(rng.random((1, n)) > 0.2),
            weights, biases, (depth, width, True), 8.0, deg, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype,width,depth,nt,n', [
    # one short tile; whole tiles; a short last tile in one frame and
    # across frames (N a multiple of 64 but not of the forward's 128)
    ('float32', 128, 4, 1, 64), ('float32', 128, 4, 2, 256),
    ('float32', 128, 4, 1, 192), ('float32', 128, 4, 3, 320),
    ('bfloat16', 128, 4, 3, 320),
    # widths that leave groups of warps, or half of a 32-row unit, idle
    ('float32', 16, 4, 3, 192), ('float32', 48, 4, 3, 192),
    ('float32', 64, 4, 3, 192), ('bfloat16', 48, 4, 3, 192),
    # the skip input feeds the head (depth 2) or layer 5 of 8
    ('float32', 128, 2, 3, 192), ('float32', 64, 8, 3, 192),
    ('bfloat16', 64, 8, 3, 192),
    # more tiles than SMs: blocks walk several tiles, the weight stream
    # wraps around
    ('float32', 128, 4, 6, 8192)])
def test_forward_matches_plain_on_card(cuda_device, compute_dtype, width,
                                       depth, nt, n):
    """Forward kernel against its plain version: emission atol 2e-6 /
    rtol 1e-4 and F to 1e-5 in f32 (2e-3 / 2e-2 and one bf16 step in
    bf16, where a value on a rounding boundary may round either way);
    the emission is bitwise the same with and without the stash and on
    a repeated call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _forward_inputs(cuda_device, np.random.default_rng(1), width,
                           depth, nt, n, compute_dtype)
    em_k, f_k = fused.render_fwd(*args, stash=True)
    em_p, f_p = fused.render_fwd_plain(*args, stash=True)
    torch.cuda.synchronize()
    assert float(em_p.max()) > 0.05
    tol, f_tol = (dict(atol=2e-6, rtol=1e-4), 1e-5) \
        if compute_dtype == 'float32' else (dict(atol=2e-3, rtol=2e-2),
                                            2.0 ** -7)
    np.testing.assert_allclose(em_k.cpu().numpy(), em_p.cpu().numpy(), **tol)
    np.testing.assert_allclose(f_k.cpu().numpy(), f_p.cpu().numpy(),
                               atol=f_tol, rtol=0)
    assert torch.equal(fused.render_fwd(*args), em_k)
    again = fused.render_fwd(*args, stash=True)
    assert torch.equal(again[0], em_k) and torch.equal(again[1], f_k)


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', ['float32', 'bfloat16'])
def test_forward_masks_are_exact_on_card(cuda_device, compute_dtype):
    """Padding samples (t_geos_rel = -1e30) and columns with smask = 0
    give exact zeros; every other column a positive emission."""
    nt, n = 3, 320
    args = list(_forward_inputs(cuda_device, np.random.default_rng(2), 128,
                                4, nt, n, compute_dtype))
    tg, smask = args[3].clone(), args[4].clone()
    tg[:, :] = 40.0              # every real sample valid in every frame
    tg[:, 250:] = -1e30          # padding samples
    smask[:, :] = 1.0
    smask[:, 5:90:7] = 0.0
    args[3], args[4] = tg, smask
    em = fused.render_fwd(*args)
    torch.cuda.synchronize()
    dead = (tg < -1e29) | (smask == 0.0)
    assert bool((em[:, dead[0]] == 0.0).all())
    assert bool((em[:, ~dead[0]] > 0.0).all())


@pytest.mark.cuda
def test_forward_many_feature_rows_on_card(cuda_device):
    """Posenc degree 8 (51 features, 64 padded rows) at width 128 leaves
    the forward less shared memory: it stages its weights in smaller
    chunks and still matches the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _forward_inputs(cuda_device, np.random.default_rng(3), 128, 4, 3,
                           320, 'float32', deg=8)
    em_k, f_k = fused.render_fwd(*args, stash=True)
    torch.cuda.synchronize()
    t_eff, coords, omega, tg, smask, weights, biases, cfg, scale, deg, _ = args
    f_p, mask = fused._prologue_plain(t_eff, coords, omega, tg, smask, scale,
                                      deg, False)
    # the double-angle recursion doubles the difference between the two
    # sin/cos implementations with every degree
    np.testing.assert_allclose(f_k.cpu().numpy(), f_p.cpu().numpy(),
                               atol=2e-4, rtol=0)
    # the MLP on the kernel's own features, so the emission is held to the
    # usual tolerance whatever the trig's difference
    out = fused._forward_chain_plain(f_k, weights, biases, cfg, False)[1]
    em_p = torch.sigmoid(out - 10.0).reshape(em_k.shape) * mask
    assert float(em_p.max()) > 0.05
    np.testing.assert_allclose(em_k.cpu().numpy(), em_p.cpu().numpy(),
                               atol=2e-6, rtol=1e-4)


def _native_args(device, seed=0):
    """Seeded polarized ray constants (8x8 rays, 40 samples) compacted in
    the 'native' layout: k-major group slots with inert filler columns."""
    rng = np.random.default_rng(seed)
    shape = (8, 8, 40)
    put = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(device)
    rt = step.RayTracingArgs(
        coords=put(rng.uniform(-9, 9, (3, *shape))),
        Omega=put(rng.uniform(0.01, 0.1, shape)),
        J=put(rng.standard_normal((3, *shape))),
        g=put(rng.uniform(0.5, 1.5, shape)),
        dtau=put(rng.uniform(0.01, 0.02, shape)),
        Sigma=put(rng.uniform(10, 100, shape)),
        t_geos_rel=put(rng.uniform(10, 30, shape)),
        t_injection=torch.zeros((), device=device))
    pred = NeRFPredictor(scale=9.0, rmin=3.0, rmax=9.0, z_width=3.0)
    return pred, step.compact_raytracing_args(rt, pred, layout='native')


@pytest.mark.cuda
@pytest.mark.parametrize('compute_dtype', ['float32', 'bfloat16'])
def test_native_layout_filler_is_inert_on_card(cuda_device, compute_dtype):
    """Both kernels on a 'native'-layout input (N a multiple of 64, not of
    the forward's 128): emission and gradients against the plain versions
    (f32: atol 2e-6 / rtol 1e-4 and 5e-5 normalised, d_t rtol 2e-3; bf16:
    2e-3 / 2e-2 and 1e-2), exact zeros in the emission of every filler
    column, a positive emission elsewhere, and gradients and d_t that are
    bitwise the same whatever cotangent arrives on the filler columns."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pred, crt = _native_args(cuda_device)
    n = crt.coords.shape[1]
    assert n % fused.TILE_N == 0 and crt.red_gather is None
    filler = crt.t_geos_rel < -1e29
    assert 0.05 < float(filler.float().mean()) < 0.7
    assert bool((crt.coords[:, filler] == 0).all())
    params = pred.init_params(generator=torch.Generator().manual_seed(0),
                              device=cuda_device)
    weights = [w.detach() for w in fused.pack_params(params)[0]]
    biases = [b.detach() + 0.3 for b in fused.pack_params(params)[1]]
    biases[-1] = biases[-1] + 8.0
    coords, omega, tg, smask, _ = fused._flatten_sample_args(
        crt.coords, crt.Omega, crt.t_geos_rel, 1.0, n)
    t_eff = torch.tensor([[0.0], [7.0], [40.0]], device=cuda_device)
    cfg = (pred.net_depth, pred.net_width, pred.do_skip)
    args = (t_eff, coords, omega, tg, smask, weights, biases, cfg,
            pred.scale, pred.posenc_deg, compute_dtype)
    em_k, f_k = fused.render_fwd(*args, stash=True)
    em_p, f_p = fused.render_fwd_plain(*args, stash=True)
    torch.cuda.synchronize()
    f32 = compute_dtype == 'float32'
    tol = dict(atol=2e-6, rtol=1e-4) if f32 else dict(atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(em_k.cpu().numpy(), em_p.cpu().numpy(), **tol)
    assert bool((em_k[:, filler] == 0.0).all())
    assert bool((em_k[:, ~filler] > 0.0).all())

    gen = torch.Generator(cuda_device).manual_seed(1)
    g = torch.randn(em_p.shape, device=cuda_device, generator=gen)
    g_noise = g.clone()
    g_noise[:, filler] = 1e3 * torch.randn(
        (g.shape[0], int(filler.sum())), device=cuda_device, generator=gen)
    bwd = (em_p, f_p, omega, weights, biases, cfg, pred.posenc_deg,
           compute_dtype, True)
    gk = fused.render_bwd(g, *bwd)
    gn = fused.render_bwd(g_noise, *bwd)
    gp = fused.render_bwd_plain(g, *bwd)
    torch.cuda.synchronize()
    for a, b in zip(gp[0] + gp[1], gk[0] + gk[1]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale,
                                   atol=5e-5 if f32 else 1e-2)
    if f32:
        np.testing.assert_allclose(gk[2].cpu().numpy(), gp[2].cpu().numpy(),
                                   rtol=2e-3, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in
               zip(gk[0] + gk[1] + [gk[2]], gn[0] + gn[1] + [gn[2]]))


@pytest.mark.cuda
def test_native_reduce_matches_segment_sum_on_card(cuda_device):
    """_NativeReduce on the card: images against the plain segment sum
    over the same slots (rtol 1e-5), and its backward against both the
    segment sum's autograd and the analytic adjoint d_em[f, i] = sum_s
    d_img[f, s, pixel_ids[i]] * weights[s, i] in float64 (rtol 1e-5);
    filler slots get exactly zero."""
    _, crt = _native_args(cuda_device, seed=1)
    n = crt.coords.shape[1]
    gen = torch.Generator(cuda_device).manual_seed(2)
    em0 = torch.rand((4, n), device=cuda_device, generator=gen)
    d_img = torch.randn((4, 3, crt.npix), device=cuda_device, generator=gen)
    outs = []
    for reduce in (lambda em: step._reduce_to_images(em, crt),
                   lambda em: step._segment_reduce(crt.npix, em,
                                                   crt.pixel_ids,
                                                   crt.weights)):
        em = em0.clone().requires_grad_(True)
        img = reduce(em)
        (img * d_img).sum().backward()
        outs.append((img.detach().cpu().numpy(), em.grad.cpu().numpy()))
    assert outs[0][0].shape == (4, 3, 64)
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-5, atol=1e-5)
    pix = crt.pixel_ids.cpu().numpy()
    d_pad = np.pad(d_img.cpu().numpy().astype(np.float64),
                   ((0, 0), (0, 0), (0, 1)))
    analytic = np.einsum('fsn,sn->fn', d_pad[:, :, pix],
                         crt.weights.cpu().numpy().astype(np.float64))
    np.testing.assert_allclose(outs[0][1], analytic, rtol=1e-5, atol=1e-5)
    filler = (crt.t_geos_rel < -1e29).cpu().numpy()
    assert (outs[0][1][:, filler] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize('width,depth', [(48, 4), (100, 4), (120, 4),
                                         (100, 2)])
def test_padded_widths_match_plain_on_card(cuda_device, width, depth):
    """Widths that are no multiple of 16 run both kernels on an MLP
    zero-padded to the next multiple: emission atol 2e-6 / rtol 1e-4 and
    gradients atol 5e-5 normalised against the plain versions of the
    unpadded MLP, d_t rtol 2e-3, including the skip layer whose h is
    padded (layer 3 of 4, the head of 2); each call launches its kernel
    once. Through the autograd Function, a width-100 loss launches one
    forward and one backward and its gradients match the plain path's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    args = _forward_inputs(cuda_device, rng, width, depth, 3, 192,
                           'float32')
    _, _, omega, _, _, weights, biases, cfg, _, deg, _ = args
    launches = (fused.render_fwd.launches, fused.render_bwd.launches)
    em_k, f_k = fused.render_fwd(*args, stash=True)
    em_p, f_p = fused.render_fwd_plain(*args, stash=True)
    g = torch.as_tensor(rng.standard_normal(em_p.shape), dtype=torch.float32,
                        device=cuda_device)
    gk = fused.render_bwd(g, em_p, f_p, omega, weights, biases, cfg, deg,
                          'float32', True)
    gp = fused.render_bwd_plain(g, em_p, f_p, omega, weights, biases, cfg,
                                deg, 'float32', True)
    torch.cuda.synchronize()
    assert (fused.render_fwd.launches - launches[0],
            fused.render_bwd.launches - launches[1]) == (1, 1)
    assert float(em_p.max()) > 0.01
    np.testing.assert_allclose(em_k.cpu().numpy(), em_p.cpu().numpy(),
                               atol=2e-6, rtol=1e-4)
    np.testing.assert_allclose(f_k.cpu().numpy(), f_p.cpu().numpy(),
                               atol=1e-5, rtol=0)
    for a, b in zip(gp[0] + gp[1], gk[0] + gk[1]):
        assert a.shape == b.shape
        a, b = a.cpu().numpy(), b.cpu().numpy()
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=5e-5)
    np.testing.assert_allclose(gk[2].cpu().numpy(), gp[2].cpu().numpy(),
                               rtol=2e-3, atol=1e-6)

    if width != 100 or depth != 4:
        return
    pred = NeRFPredictor(scale=8.0, net_depth=depth, net_width=width)
    t_eff, coords, omega, tg, smask = args[:5]
    grads = []
    for on_card in (True, False):
        params = pred.init_params(generator=torch.Generator().manual_seed(3),
                                  device=cuda_device)
        with torch.no_grad():
            params.mlp.layers[-1].bias += 8.0
        before = (fused.render_fwd.launches, fused.render_bwd.launches)
        if on_card:
            em = fused.fused_render(params, coords, omega, tg, smask, t_eff,
                                    cfg, 8.0, deg)
        else:
            w, b = fused.pack_params(params)
            em = _PlainRender.apply(t_eff, coords, omega, tg, smask, cfg,
                                    deg, *w, *b)
        (em * g).sum().backward()
        after = (fused.render_fwd.launches, fused.render_bwd.launches)
        assert (after[0] - before[0], after[1] - before[1]) == \
            ((1, 1) if on_card else (0, 0))
        grads.append([p.grad.cpu().numpy() for p in params.parameters()])
    for a, b in zip(grads[1], grads[0]):
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=5e-5)


class _PlainRender(torch.autograd.Function):
    """The plain versions of both kernels as an autograd Function: the
    reference the card's fused path is held to."""

    @staticmethod
    def forward(ctx, t_eff, coords, omega, tg, smask, cfg, deg, *tensors):
        n_layers = cfg[0] + 1
        weights, biases = tensors[:n_layers], tensors[n_layers:]
        em, f_store = fused.render_fwd_plain(t_eff, coords, omega, tg, smask,
                                             weights, biases, cfg, 8.0, deg,
                                             stash=True)
        ctx.cfg, ctx.deg = cfg, deg
        ctx.save_for_backward(em, f_store, omega, *tensors)
        return em

    @staticmethod
    def backward(ctx, g_em):
        em, f_store, omega, *tensors = ctx.saved_tensors
        n_layers = ctx.cfg[0] + 1
        gw, gb, _ = fused.render_bwd_plain(
            g_em, em, f_store, omega, tensors[:n_layers], tensors[n_layers:],
            ctx.cfg, ctx.deg)
        return (None,) * 7 + (*gw, *gb)


@pytest.mark.cuda
def test_width_over_128_raises_on_card(cuda_device):
    """Width 256 is refused by both wrappers before any launch, with a
    ValueError that says why; there is no fallback to the plain
    versions."""
    args = _forward_inputs(cuda_device, np.random.default_rng(3), 256, 4, 1,
                           64, 'float32')
    launches = (fused.render_fwd.launches, fused.render_bwd.launches)
    with pytest.raises(ValueError, match='net_width up to 128'):
        fused.render_fwd(*args)
    em, f = fused.render_fwd_plain(*args, stash=True)
    with pytest.raises(ValueError, match='net_width up to 128'):
        fused.render_bwd(em, em, f, args[2], args[5], args[6], args[7], 3)
    assert (fused.render_fwd.launches, fused.render_bwd.launches) == launches


def _hotspot():
    return emission.generate_hotspot((16, 16, 16), [0, 0, 1], 0.0,
                                     orbit_radius=5.9, std=0.7, r_isco=5.33,
                                     fov=16.0)


@pytest.mark.cuda
def test_interpolate_coords_on_card_matches_cpu(cuda_device):
    """Trilinear sampling on the card equals the same function on the CPU
    for points inside, on the border and outside the grid (atol 1e-8 of a
    field whose peak is 0.1)."""
    pts = np.random.default_rng(4).uniform(-9.0, 9.0, (4096, 3)) \
        .astype(np.float32)
    hot = _hotspot()
    cpu = emission.interpolate_coords(hot, torch.as_tensor(pts))
    card = emission.interpolate_coords(hot, torch.as_tensor(pts).to(
        cuda_device))
    assert card.device.type == 'cuda'
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), atol=1e-8,
                               rtol=0)


@pytest.mark.cuda
def test_image_plane_dynamics_on_card_matches_cpu(cuda_device):
    """The forward movie renderer on the card equals the same function on
    the CPU (an 8x8x32 table, 6 frames in chunks of 4, Stokes factors J):
    atol 1e-5 of the movie's max (the card's trigonometry differs in the
    last bits)."""
    geos = image_plane_geos(spin=0.2, inclination=np.deg2rad(60.0),
                            alpha_range=(-8, 8), beta_range=(-8, 8), ngeo=32,
                            num_alpha=8, num_beta=8, n_fine=512)
    J = np.random.default_rng(5).uniform(-1, 1, (3, 8, 8, 32))
    t = units.Quantity(np.linspace(0.0, 1.0, 6), 'hr')
    movies = [emission.image_plane_dynamics(
        _hotspot(), geos, geos.keplerian_omega(), t, -float(geos.r_o + 4),
        J=J, frame_chunk=4, device=device).cpu().numpy()
        for device in ('cpu', cuda_device)]
    assert movies[0].shape == (6, 3, 8, 8)
    scale = np.abs(movies[0]).max()
    assert scale > 0
    np.testing.assert_allclose(movies[1] / scale, movies[0] / scale,
                               atol=1e-5, rtol=0)


def _eht_problem(device, dtype, operator, nt=6, npix=16, ngeo=32):
    """A seeded synthetic 16x16x32 ray table compacted on `device`, frames
    over the ngEHT scan window (4.0-15.5 UT, ~2,020 M: Omega * t reaches
    ~160 rad) and the EHT2017 observation of a seeded movie as `dtype`
    measurements with the `operator` form, on `device`."""
    from bhnerf_tpu_torch import constants, observation
    rng = np.random.default_rng(6)
    shape = (npix, npix, ngeo)
    fields = dict(
        coords=np.stack([rng.uniform(-6, 6, shape), rng.uniform(-6, 6, shape),
                         rng.uniform(-1.5, 1.5, shape)]),
        Omega=rng.uniform(0.02, 0.08, shape), g=rng.uniform(0.5, 1.5, shape),
        dtau=rng.uniform(0.5, 1.0, shape), Sigma=rng.uniform(0.5, 1.0, shape),
        t_geos_rel=rng.uniform(0.0, 50.0, shape))
    t_hr = np.linspace(4.0, 15.5, nt).astype(np.float32)
    rt = step.RayTracingArgs(
        **{k: torch.as_tensor(v.astype(np.float32)).to(device)
           for k, v in fields.items()}, J=1.0,
        t_injection=torch.zeros((), device=device), t_start_obs=4.0,
        t_to_M=1.0 / constants.GM_c3(constants.sgra_mass).to('hr').value,
        t_units=units.hr)
    pred = NeRFPredictor(scale=8.0, rmax=8.0, z_width=2.0)
    crt = step.compact_raytracing_args(rt, pred, layout='gather')
    ob = observation.observe_same(
        rng.random((nt, npix, npix)), t_hr, 1e-10,
        observation.empty_eht_obs(observation.load_txt(
            'eht_arrays/EHT2017.txt'), nt=nt, tint=60.0), seed=0)
    data = step.to_real_measurements(dtype, *ob.chisqdata(
        t_hr, dtype, 1e-10 * npix, npix, operator=operator))
    data = [torch.as_tensor(x).to(device) for x in data]
    return pred, crt, crt.frame_times_M(torch.as_tensor(t_hr).to(device)), \
        data


@pytest.mark.cuda
@pytest.mark.parametrize('operator', ['dense', 'factored'])
@pytest.mark.parametrize('dtype', ['vis', 'logcamp'])
def test_eht_losses_match_plain_on_card(cuda_device, monkeypatch, dtype,
                                        operator):
    """The EHT loss and its parameter gradients through the kernels
    against the same loss through the kernels' plain versions, on the
    card, over the 11.5-hr scan window: loss rtol 1e-4, gradients atol
    1e-4 after normalising by their max; one launch of each kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pred, crt, t_M, data = _eht_problem(cuda_device, dtype, operator)
    results = []
    for route in ('kernel', 'plain'):
        if route == 'plain':
            monkeypatch.setattr(fused, 'render_fwd', fused.render_fwd_plain)
            monkeypatch.setattr(fused, 'render_bwd', fused.render_bwd_plain)
        params = pred.init_params(generator=torch.Generator().manual_seed(0),
                                  device=cuda_device)
        with torch.no_grad():
            params.mlp.layers[-1].bias += 8.0
        fused.render_fwd.launches = fused.render_bwd.launches = 0
        loss, [images] = step.loss_fn_eht(params, pred, *data, t_M, crt, 1.0,
                                          dtype, fused=True)
        loss.backward()
        torch.cuda.synchronize()
        if route == 'kernel':
            assert (fused.render_fwd.launches,
                    fused.render_bwd.launches) == (1, 1)
        assert tuple(images.shape) == (6, 16, 16)
        results.append((float(loss.detach()),
                        [p.grad.cpu().numpy() for p in params.parameters()]))
    (loss_k, grads_k), (loss_p, grads_p) = results
    assert np.isfinite(loss_k) and loss_k > 0
    np.testing.assert_allclose(loss_k, loss_p, rtol=1e-4)
    for a, b in zip(grads_k, grads_p):
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)


def _allow_tf32(allow):
    """Set cuBLAS's TF32 permission; return a function that restores the
    previous setting."""
    mm = torch.backends.cuda.matmul
    prev = mm.fp32_precision
    mm.fp32_precision = 'tf32' if allow else 'ieee'
    return lambda: setattr(mm, 'fp32_precision', prev)


@pytest.mark.cuda
@pytest.mark.parametrize('operator', ['dense', 'factored'])
def test_measurement_operator_ignores_tf32_on_card(cuda_device, operator):
    """The operator's products, forward and backward, give bitwise the
    same visibilities and image cotangents with TF32 allowed as without,
    and agree with float64 on the host to 1e-5 of the max (npix 64: a
    dense visibility sums 4096 terms); a plain torch.matmul of the same
    depth shows that TF32 was on."""
    _, _, _, (_, _, A) = _eht_problem(cuda_device, 'vis', operator, nt=2,
                                      npix=64, ngeo=2)
    rng = np.random.default_rng(7)
    img = torch.as_tensor(rng.random((2, 64, 64)), dtype=torch.float32,
                          device=cuda_device)
    g = torch.as_tensor(rng.standard_normal((2, 2, A.shape[-2])),
                        dtype=torch.float32, device=cuda_device)
    # a plain product of the same depth that TF32 does reach
    rows = A.reshape(-1, A.shape[-1])[:256]
    cols = torch.as_tensor(rng.random((A.shape[-1], 64)),
                           dtype=torch.float32, device=cuda_device)
    out = {}
    for allow in (False, True):
        restore = _allow_tf32(allow)
        try:
            x = img.clone().requires_grad_()
            vis = step.apply_measurement_operator(x, A)
            vis.backward(g)
            dense = rows @ cols
            torch.cuda.synchronize()
        finally:
            restore()
        out[allow] = (vis.detach(), x.grad, dense)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    x64 = img.double().cpu().requires_grad_()
    vis64 = step.apply_measurement_operator(x64, A.double().cpu())
    vis64.backward(g.double().cpu())
    for ours, ref in ((out[False][0], vis64), (out[False][1], x64.grad)):
        ref = ref.detach().numpy()
        np.testing.assert_allclose(ours.cpu().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    ref = (rows.double() @ cols.double()).cpu().numpy()
    err = lambda r: float(np.abs(r.cpu().numpy() - ref).max())
    assert err(out[True][2]) > 10 * err(out[False][2])


def _tutorial3_fit(device, nt=12, width=128):
    """The Tutorial-3 training step at a small size on the card: seeded
    ray constants (16x16 rays, 64 samples) compacted in the 'gather'
    layout, the 4-layer MLP (width 128 unless said), the fused 'full'
    image loss on a seeded movie."""
    from bhnerf_tpu_torch.train.optimizer import TrainStep
    rng = np.random.default_rng(3)
    shape = (16, 16, 64)
    put = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(device)
    rt = step.RayTracingArgs(
        coords=put(rng.uniform(-8, 8, (3, *shape))),
        Omega=put(rng.uniform(0.01, 0.1, shape)), J=1.0,
        g=put(rng.uniform(0.5, 1.5, shape)),
        dtau=put(rng.uniform(0.01, 0.02, shape)),
        Sigma=put(rng.uniform(10, 100, shape)),
        t_geos_rel=put(rng.uniform(0, 30, shape)),
        t_injection=torch.zeros((), device=device), t_to_M=100.0,
        t_units=units.hr)
    pred = NeRFPredictor(scale=8.0, rmin=3.0, rmax=8.0, z_width=2.0,
                         net_width=width)
    crt = step.compact_raytracing_args(rt, pred, layout='gather')
    t_q = units.Quantity(np.linspace(0.0, 0.1, nt), 'hr')
    target = 0.02 * rng.random((nt, 16, 16), dtype=np.float32)
    train_step = TrainStep.image(t_q, target, pred, fused=True,
                                 device=device)
    return pred, crt, train_step


@pytest.mark.cuda
@pytest.mark.parametrize('route', ['make_scan_step', 'Optimizer'])
@pytest.mark.parametrize('width', [128, 100])
def test_chunk_runs_without_synchronising_on_card(cuda_device, width, route):
    """The first chunk of a fit, 8 Tutorial-3 steps with its frame indices
    already on the card, runs under torch.cuda.set_sync_debug_mode('error'):
    nothing inside it (Adam's first update included) reads a value back,
    copies from the host or synchronises, at width 128 and at a width the
    wrappers pad to 112, through make_scan_step and through the
    Optimizer's chunk (TrainStep calls); it launches one forward and one
    backward kernel a step, and its losses are finite."""
    from bhnerf_tpu_torch.train.optimizer import Optimizer
    from bhnerf_tpu_torch.train.state import TrainState, make_optimizer
    fused._lib()                        # the build, outside the chunk
    pred, crt, train_step = _tutorial3_fit(cuda_device, width=width)
    state = TrainState.create(
        pred.init_params(generator=torch.Generator().manual_seed(0),
                         device=cuda_device), make_optimizer(20))
    frames = train_step.args[0].device_args
    gen = torch.Generator().manual_seed(1)
    indices = torch.stack([torch.randperm(12, generator=gen)[:4]
                           for _ in range(8)]).to(cuda_device)
    if route == 'Optimizer':
        opt = Optimizer({'num_iters': 20}, pred, crt, device=cuda_device)
        opt.state = state

        def fn(state, *args):
            return opt.state, opt._chunk(train_step, [crt], indices, [0] * 8)
    else:
        fn = step.make_scan_step(batchsize=4, chunk=8,
                                 **train_step.scan_meta)
    torch.cuda.synchronize()
    fused.render_fwd.launches = fused.render_bwd.launches = 0
    torch.cuda.set_sync_debug_mode('error')
    try:
        state, losses = fn(state, *frames, indices, [0] * 8, crt, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (fused.render_fwd.launches, fused.render_bwd.launches) == (8, 8)
    assert tuple(losses.shape) == (8,)
    assert bool(torch.isfinite(losses).all()) and state.step == 8


@pytest.mark.cuda
def test_chunked_run_matches_per_step_run_on_card(cuda_device):
    """Optimizer.run with scan_chunk=8 and the per-step loop from the same
    seed draw the same batches and give the same loss series on the card,
    to float32 round-off (the per-pixel reduce sums with atomics, so the
    two runs are not bitwise equal): rtol 1e-5 at every step."""
    from bhnerf_tpu_torch.train.optimizer import LogFn, Optimizer
    pred, crt, train_step = _tutorial3_fit(cuda_device)
    series = {}
    for scan_chunk in (0, 8):
        opt = Optimizer({'num_iters': 20, 'lr_init': 1e-3, 'seed': 4}, pred,
                        crt, device=cuda_device)
        seen = series[scan_chunk] = []
        opt.run(4, train_step, crt, verbose=False, scan_chunk=scan_chunk,
                log_fns=[LogFn(lambda o: seen.append((o.step,
                                                      float(o.loss))))])
    assert [s for s, _ in series[8]] == list(range(1, 21))
    np.testing.assert_allclose([l for _, l in series[8]],
                               [l for _, l in series[0]], rtol=1e-5)


def _trace_inputs(device, npix=8, variants=1, spin=0.94, fov=16.0):
    """initial_state of the float32 trace (inclination 60 deg) over
    `variants` jittered npix x npix screens of one seed, on `device`."""
    from bhnerf_tpu_torch.geodesics import integrator
    from bhnerf_tpu_torch.geodesics.dataset import subpixel_jittered_axes
    rng = np.random.default_rng(0)
    grids = [np.meshgrid(*subpixel_jittered_axes(
        (-fov / 2, fov / 2), (-fov / 2, fov / 2), npix, npix, rng),
        indexing='ij') for _ in range(variants)]
    alpha = np.stack([a for a, _ in grids]).astype(np.float32).ravel()
    beta = np.stack([b for _, b in grids]).astype(np.float32).ravel()
    state0, lam, eta = integrator.initial_state(alpha, beta, spin,
                                                np.deg2rad(60.0), 1000.0,
                                                torch.float32)
    return (integrator.RayState(*(x.to(device) for x in state0)),
            lam.to(device), eta.to(device))


def _table(samples):
    """(r, theta, t) of the tracer's samples as trace_geodesics forms
    them, and (phi, pm_r, pm_th) as recorded, (rays, ngeo) each."""
    s = {k: v.cpu().numpy().T for k, v in samples.items()}
    return ((1.0 / s['u'], np.arccos(np.clip(s['c'], -1.0, 1.0)),
             s['t'].astype(np.float64) - s['t_c'].astype(np.float64)),
            (s['phi'], s['pm_r'], s['pm_th']))


@pytest.mark.cuda
def test_geodesic_kernel_matches_plain_on_card(cuda_device):
    """The tracer kernel against its plain version (the float32 torch loop)
    on the same card inputs, 8x8 rays x 24 samples at n_fine 512, on all
    seven fields it writes: the device trace's gate (p90 dr/r < 1e-4,
    dtheta < 1e-3, |dt| < 1e-3, in the domain r <= 16 max |dt| < 1 M and
    p99 < 1e-2, no re-entry), its p90 bars of dr/r and dtheta held at the
    99th percentile, phi under t's bars, the momentum signs equal on every
    sample of the rays of the same terminal Mino time, median |dt| and
    |dphi| < 2e-4, and the same terminal Mino time on >= 95% of the rays;
    one launch on the counter."""
    from bhnerf_tpu_torch.geodesics import integrator
    from bhnerf_tpu_torch.scripts.drive_device_geos import (
        compare, compare_phi_signs)
    state0, lam, eta = _trace_inputs(cuda_device)
    kw = dict(r_o=1000.0, n_fine=512, ngeo=24)
    before = integrator.trace_rays.launches
    tau_k, s_k = integrator.trace_rays(state0, 0.94, lam, eta, **kw)
    assert integrator.trace_rays.launches == before + 1
    tau_p, s_p = integrator.trace_rays_plain(state0, 0.94, lam, eta, **kw)
    torch.cuda.synchronize()
    assert integrator.trace_rays.launches == before + 1
    assert set(s_k) == set(s_p)
    for k in s_k:
        assert s_k[k].shape == s_p[k].shape == (24, 64)
        assert s_k[k].dtype == torch.float32 and s_k[k].is_cuda
    (table_k, rest_k), (table_p, rest_p) = _table(s_k), _table(s_p)
    q = compare(table_k, table_p, 16.0)
    assert q['ok'] and q['median_dt'] < 2e-4, q
    assert q['p99_dr_rel'] < 1e-4 and q['p99_dtheta'] < 1e-3, q
    same = (tau_k == tau_p).cpu().numpy()
    assert same.mean() >= 0.95
    q = compare_phi_signs(table_k[0], rest_k, rest_p, same, 16.0)
    assert q['ok'] and q['median_dphi'] < 2e-4, q


@pytest.mark.cuda
def test_geodesic_kernel_ensemble_is_one_launch_on_card(cuda_device):
    """Three stacked 8x8 screens trace in one launch, bitwise equal to one
    launch per screen (one thread a ray: no ray sees another)."""
    from bhnerf_tpu_torch.geodesics import integrator
    state0, lam, eta = _trace_inputs(cuda_device, variants=3)
    kw = dict(r_o=1000.0, n_fine=512, ngeo=24)
    before = integrator.trace_rays.launches
    tau, samples = integrator.trace_rays(state0, 0.94, lam, eta, **kw)
    assert integrator.trace_rays.launches == before + 1
    for v in range(3):
        part = slice(64 * v, 64 * (v + 1))
        tau_v, s_v = integrator.trace_rays(
            integrator.RayState(*(x[part].contiguous() for x in state0)),
            0.94, lam[part].contiguous(), eta[part].contiguous(), **kw)
        assert torch.equal(tau_v, tau[part])
        for k in s_v:
            assert torch.equal(s_v[k], samples[k][:, part]), k
    assert integrator.trace_rays.launches == before + 4


@pytest.mark.cuda
def test_geodesic_kernel_refuses_other_inputs_on_card(cuda_device):
    """A CUDA tensor that is not float32, not contiguous or of another
    length raises before any launch; CPU tensors take the plain version
    and leave the counter still."""
    from bhnerf_tpu_torch.geodesics import integrator
    state0, lam, eta = _trace_inputs(cuda_device)
    kw = dict(r_o=1000.0, n_fine=64, ngeo=4)
    before = integrator.trace_rays.launches
    bad = [
        (integrator.RayState(*(x.double() for x in state0)), lam.double(),
         eta.double()),
        (state0, lam.repeat(2)[::2], eta),
        (state0, lam[:10].contiguous(), eta),
    ]
    for s, l, e in bad:
        with pytest.raises(ValueError, match='float32'):
            integrator.trace_rays(s, 0.94, l, e, **kw)
    cpu = (integrator.RayState(*(x.cpu() for x in state0)), lam.cpu(),
           eta.cpu())
    tau, samples = integrator.trace_rays(cpu[0], 0.94, *cpu[1:], **kw)
    assert tau.device.type == 'cpu' and samples['u'].device.type == 'cpu'
    assert integrator.trace_rays.launches == before


@pytest.mark.cuda
def test_trace_geodesics_device_backend_on_card(cuda_device):
    """trace_geodesics(backend='device') on the card: one launch, r in
    float32 and t folded in float64 as the reference returns them, and
    the same table (to the gate) as the plain version's on the CPU;
    backend='cpu' (the default) and device='cpu' launch nothing."""
    from bhnerf_tpu_torch.geodesics import integrator, trace_geodesics
    from bhnerf_tpu_torch.scripts.drive_device_geos import compare, table
    axis = np.linspace(-8.0, 8.0, 8)
    alpha, beta = np.meshgrid(axis, axis, indexing='ij')
    kw = dict(ngeo=24, n_fine=512)
    before = integrator.trace_rays.launches
    g = trace_geodesics(alpha, beta, 0.5, np.deg2rad(60.0), backend='device',
                        device=cuda_device, **kw)
    assert integrator.trace_rays.launches == before + 1
    assert g.r.dtype == g.theta.dtype == np.float32
    assert g.t.dtype == np.float64 and g.r.shape == (8, 8, 24)
    assert np.isfinite(g.r).all() and np.isfinite(g.t).all()
    g_cpu = trace_geodesics(alpha, beta, 0.5, np.deg2rad(60.0),
                            backend='device', device='cpu', **kw)
    g64 = trace_geodesics(alpha, beta, 0.5, np.deg2rad(60.0), **kw)
    assert integrator.trace_rays.launches == before + 1
    assert g64.r.dtype == np.float64
    assert compare(table(g), table(g_cpu), 16.0)['ok']
    assert compare(table(g), table(g64), 16.0)['ok']


@pytest.mark.cuda
def test_rho_of_req_device_backend_on_card(cuda_device):
    """rho_of_req(backend='device') on the card: 1 + iters + 1 tracer
    launches; every root within two bisection brackets of the plain
    float32 tracer's (device='cpu') and of the host float64 trace's, and
    its rays cross the equator within the reference's 1e-2 req of req on
    the host float64 trace."""
    from bhnerf_tpu_torch.geodesics import equatorial, integrator
    inc, req, iters = np.deg2rad(20.0), 6.0, 8
    kw = dict(varphis=np.linspace(-np.pi, np.pi, 4, endpoint=False),
              iters=iters, ngeo=48, n_fine=512)
    bracket = (12.0 - 1.0) / 47 / 2**iters
    before = integrator.trace_rays.launches
    _, rho = equatorial.rho_of_req(0.0, inc, req, backend='device',
                                   device=cuda_device, **kw)
    assert integrator.trace_rays.launches == before + iters + 2
    _, rho_plain = equatorial.rho_of_req(0.0, inc, req, backend='device',
                                         device='cpu', **kw)
    _, rho_host = equatorial.rho_of_req(0.0, inc, req, **kw)
    assert integrator.trace_rays.launches == before + iters + 2
    assert np.isfinite(rho).all()
    np.testing.assert_array_less(np.abs(rho - rho_plain), 2 * bracket)
    np.testing.assert_array_less(np.abs(rho - rho_host), 2 * bracket)
    phis = kw['varphis']
    r, _ = equatorial.r_equatorial(0.0, np.inf, inc, 0, rho * np.cos(phis),
                                   rho * np.sin(phis), ngeo=48, n_fine=512)
    np.testing.assert_array_less(np.abs(r - req), 1e-2 * req)


@pytest.mark.cuda
def test_two_stokes_lc_step_matches_plain_on_card(cuda_device, monkeypatch):
    """The 'lc' loss of Q and U rows (2-row Stokes weights, the synthetic
    fit's) with a learnable injection time, compacted in the 'gather'
    layout on the card: through the kernels against through their plain
    versions, loss rtol 1e-4, parameter gradients atol 1e-4 after
    normalising by their max, d loss / d t_injection (the backward's
    frame-time cotangent) rtol 2e-3; one launch of each kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    shape = (8, 8, 16)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(
        cuda_device)
    rt = step.RayTracingArgs(
        coords=f32(np.stack([rng.uniform(-7, 7, shape),
                             rng.uniform(-7, 7, shape),
                             rng.uniform(-2.5, 2.5, shape)])),
        Omega=f32(rng.uniform(0.02, 0.08, shape)),
        J=f32(rng.uniform(-1.0, 1.0, (2, *shape))),
        g=f32(rng.uniform(0.5, 1.5, shape)),
        dtau=f32(rng.uniform(0.5, 1.0, shape)),
        Sigma=f32(rng.uniform(0.5, 1.0, shape)),
        t_geos_rel=f32(rng.uniform(0.0, 50.0, shape)),
        t_injection=f32(0.0), t_to_M=100.0, t_units=units.hr)
    pred = NeRFPredictor(scale=8.0, rmax=8.0, z_width=2.0, net_depth=4,
                         net_width=128, learn_injection=True)
    (crt,) = step.compact_ensemble_args([rt], pred, layout='gather')
    assert crt.num_stokes == 2
    target = f32(0.1 * rng.standard_normal((3, 2)))
    sigma = f32(np.full((3, 2), 0.01))
    t_M = f32([0.0, 7.0, 20.0])
    results = []
    for route in ('kernel', 'plain'):
        if route == 'plain':
            monkeypatch.setattr(fused, 'render_fwd', fused.render_fwd_plain)
            monkeypatch.setattr(fused, 'render_bwd', fused.render_bwd_plain)
        params = pred.init_params(generator=torch.Generator().manual_seed(0),
                                  device=cuda_device)
        with torch.no_grad():
            params.mlp.layers[-1].bias += 8.0
            params.t_injection += 0.5
        fused.render_fwd.launches = fused.render_bwd.launches = 0
        loss, _ = step.loss_fn_image(params, pred, target, sigma,
                                     torch.zeros_like(target), t_M, crt, 1.0,
                                     'lc', fused=True)
        loss.backward()
        torch.cuda.synchronize()
        if route == 'kernel':
            assert (fused.render_fwd.launches,
                    fused.render_bwd.launches) == (1, 1)
        results.append((float(loss.detach()),
                        [p.grad.cpu().numpy()
                         for p in params.mlp.parameters()],
                        float(params.t_injection.grad)))
    (loss_k, grads_k, dt_k), (loss_p, grads_p, dt_p) = results
    assert np.isfinite(loss_k) and loss_k > 0
    np.testing.assert_allclose(loss_k, loss_p, rtol=1e-4)
    for a, b in zip(grads_k, grads_p):
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)
    assert abs(dt_p) > 0
    np.testing.assert_allclose(dt_k, dt_p, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize('weights', ['polarized', 'random_sign'])
def test_production_ensemble_step_matches_plain_on_card(cuda_device,
                                                        monkeypatch, weights):
    """A step of the production ALMA fit's shape on the card: two seeded
    64x64x100 ray tables, compacted together in the 'gather' layout (one
    padded N of about 48k), the 4x128 MLP, 6 frames of a 20-frame 'lc'
    target. The I, Q and U weights are those of a polarized source (a
    positive I factor, Q and U at 30% of it along an EVPA that turns with
    the azimuth) or uniform in [-1, 1] with random signs, whose sums
    cancel. A TrainStep on each variant launches each kernel once. On
    each variant the 'lc' loss and its parameter gradients go through the
    kernels, through their plain versions in float32, and through the
    plain (unfused) path in float64, the witness. The kernels' loss is
    within rtol 1e-4 of the plain version's; the error of the kernels'
    gradients against the witness (max over layers of the max abs
    difference over the witness's max) is at most twice the plain float32
    version's; for the polarized source the kernels' gradients are also
    within atol 1e-4 of the plain version's after normalising by the
    max. On an H100 the two errors were 8.5e-6 / 8.3e-6 and 6.2e-6 /
    4.3e-6 for the polarized source and 1.28e-3 / 1.28e-3 and 3.46e-3 /
    3.41e-3 with random signs: there the float32 sums lose digits to
    cancellation, in the kernels as in the plain version."""
    import dataclasses

    from bhnerf_tpu_torch.train.optimizer import TrainStep
    from bhnerf_tpu_torch.train.state import TrainState, make_optimizer
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    shape = (64, 64, 100)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(
        cuda_device)

    def stokes_factors(x, y):
        if weights == 'random_sign':
            return rng.uniform(-1.0, 1.0, (3, *shape))
        I = rng.uniform(0.5, 1.5, shape)
        chi = 0.5 * np.arctan2(y, x) + 0.3
        return np.stack([I, 0.3 * I * np.cos(2 * chi),
                         0.3 * I * np.sin(2 * chi)])

    xs = [rng.uniform(-20, 20, (2, *shape)) for _ in range(2)]
    rts = [step.RayTracingArgs(
        coords=f32(np.stack([x, y, rng.uniform(-6, 6, shape)])),
        Omega=f32(rng.uniform(0.005, 0.07, shape)),
        J=f32(stokes_factors(x, y)),
        g=f32(rng.uniform(0.5, 1.5, shape)),
        dtau=f32(rng.uniform(0.01, 0.02, shape)),
        Sigma=f32(rng.uniform(10, 100, shape)),
        t_geos_rel=f32(rng.uniform(0.0, 50.0, shape)),
        t_injection=f32(0.0), t_to_M=100.0, t_units=units.hr)
        for x, y in xs]
    pred = NeRFPredictor(scale=20.0, rmin=6.0, rmax=20.0, z_width=4.0)
    crts = step.compact_ensemble_args(rts, pred, layout='gather')
    assert crts[0].coords.shape == crts[1].coords.shape
    t_q = units.Quantity(np.linspace(9.34, 10.9, 20), 'hr')
    target = 0.1 * rng.standard_normal((20, 3))
    sigma = np.array([0.15, 1e-2, 1e-2])
    train_step = TrainStep.image(t_q, target, pred, sigma=sigma, dtype='lc',
                                 fused=True, device=cuda_device)
    idx = np.sort(rng.choice(20, 6, replace=False))

    def fresh_params():
        params = pred.init_params(generator=torch.Generator().manual_seed(0),
                                  device=cuda_device)
        with torch.no_grad():
            params.mlp.layers[-1].bias += 8.0
        return params

    def as_float64(crt):
        return dataclasses.replace(crt, **{
            f.name: getattr(crt, f.name).double()
            for f in dataclasses.fields(crt)
            if torch.is_tensor(getattr(crt, f.name))
            and getattr(crt, f.name).is_floating_point()})

    for variant in (0, 1):
        state = TrainState.create(fresh_params(), make_optimizer(10))
        fused.render_fwd.launches = fused.render_bwd.launches = 0
        loss, state, _ = train_step(state, crts, torch.as_tensor(idx),
                                    variant=variant)
        assert np.isfinite(float(loss))
        assert (fused.render_fwd.launches,
                fused.render_bwd.launches) == (1, 1)

    t_M = crts[0].frame_times_M(np.asarray(t_q.value[idx], np.float32))
    results = {}
    for route in ('witness', 'kernel', 'plain'):
        if route == 'plain':
            monkeypatch.setattr(fused, 'render_fwd', fused.render_fwd_plain)
            monkeypatch.setattr(fused, 'render_bwd', fused.render_bwd_plain)
        put = f32 if route != 'witness' else (
            lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(
                cuda_device))
        for variant in (0, 1):
            params, crt = fresh_params(), crts[variant]
            if route == 'witness':
                params, crt = params.double(), as_float64(crt)
            loss, _ = step.loss_fn_image(
                params, pred, put(target[idx]), put(np.ones((6, 3)) * sigma),
                put(np.zeros((6, 3))), put(t_M), crt, 1.0, 'lc',
                fused=route != 'witness')
            loss.backward()
            torch.cuda.synchronize()
            results[route, variant] = (
                float(loss.detach()), [p.grad.double().cpu().numpy()
                                       for p in params.mlp.parameters()])

    def grad_error(route, variant):
        return max(np.abs(a - b).max() / np.abs(b).max()
                   for a, b in zip(results[route, variant][1],
                                   results['witness', variant][1]))

    for variant in (0, 1):
        (loss_k, g_k), (loss_p, g_p) = (results['kernel', variant],
                                        results['plain', variant])
        err_k, err_p = grad_error('kernel', variant), grad_error('plain',
                                                                  variant)
        print(f'{weights} variant {variant}: loss kernel {loss_k!r}, plain '
              f'{loss_p!r}, witness {results["witness", variant][0]!r}; '
              f'gradient error against the witness: kernel {err_k:.3e}, '
              f'plain {err_p:.3e}')
        assert np.isfinite(loss_k) and loss_k > 0
        np.testing.assert_allclose(loss_k, loss_p, rtol=1e-4)
        assert err_k <= 2 * err_p, (err_k, err_p)
        if weights == 'polarized':
            for a, b in zip(g_k, g_p):
                scale = np.abs(b).max() + 1e-8
                np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)
    assert results['kernel', 0][0] != results['kernel', 1][0]


@pytest.mark.cuda
def test_grid_predictor_on_card_matches_cpu(cuda_device):
    """GridPredictor's trilinear lookup (points beyond the grid included),
    its emission and the gradient of a loss on its grid, on the card
    against the same calls on the host: emission atol 1e-6, gradient
    atol 1e-6 after normalising by its max."""
    from bhnerf_tpu_torch.models.fields import GridPredictor
    rng = np.random.default_rng(5)
    pred = GridPredictor(scale=4.0, rmin=1.0, rmax=5.0, z_width=2.0,
                         grid_res=16)
    grid = rng.normal(8.0, 4.0, (16, 16, 16)).astype(np.float32)
    warped = rng.uniform(-5.2, 5.2, (6, 500, 3)).astype(np.float32)
    valid = rng.random((6, 500)) < 0.8
    coords = rng.uniform(-6, 6, (3, 500)).astype(np.float32)
    out = {}
    for device in ('cpu', cuda_device):
        params = pred.params_from_jax({'grid': grid}, device=device)
        put = lambda x: torch.as_tensor(x).to(device)
        em = pred.emission_at(params, put(warped), put(valid), put(coords))
        (em ** 2).sum().backward()
        out[str(device)] = (em.detach().cpu().numpy(),
                            params.grid.grad.cpu().numpy())
    (em_h, g_h), (em_d, g_d) = out['cpu'], out[str(cuda_device)]
    assert np.abs(em_h).max() > 0
    np.testing.assert_allclose(em_d, em_h, atol=1e-6, rtol=0)
    scale = np.abs(g_h).max()
    np.testing.assert_allclose(g_d / scale, g_h / scale, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_two_gloo_ranks_on_card_match_one_process(cuda_device, tmp_path):
    """Two gloo ranks on cuda:0 (bhnerf_tpu_torch.scripts.drive_multigpu,
    NCCL refuses two ranks on one device) at a small size: the sharded
    device traces equal the one-process traces bitwise; under mesh (1, 2)
    the sample-parallel 'full' step's images match one process on the
    card to rtol 2e-5, its loss to 2e-5 and its gradients to 2e-4 (each
    with a floor of 1e-6 of the largest magnitude), with one image
    all-reduce per forward and one gradient all-reduce per step; each rank
    launched the forward, backward and trace kernels."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from bhnerf_tpu_torch.scripts import drive_multigpu as drive

    fov, npix = 16.0, 16
    axis = np.linspace(-fov / 2, fov / 2, npix)
    alpha, beta = np.meshgrid(axis, axis, indexing='ij')
    kw = dict(spin=0.2, inclination=float(np.deg2rad(60)), ngeo=32,
              n_fine=1024)
    geos = drive.trace_geodesics(alpha, beta, backend='device',
                                 device=cuda_device, **kw)
    model = {'spin': 0.0, 'fov_M': 40.0, 'z_width': 4, 'rmin': 'ISCO',
             'Q_frac': 0.85, 'b_consts': {'arad': 0, 'avert': 1, 'ator': 0},
             'Omega_dir': 'cw', 'Omega_frac': 1.0, 'num_alpha': npix,
             'num_beta': npix, 't_start_obs': 9.34}
    a_alpha, a_beta = drive.alma_screens(model, 2, 0)
    alma_kw = dict(kw, spin=0.0)
    alma_geos = drive.trace_geodesics(a_alpha[0], a_beta[0],
                                      backend='device', device=cuda_device,
                                      **alma_kw)
    t3 = dict(predictor=dict(scale=fov / 2, rmin=3.0, rmax=fov / 2,
                             z_width=2.0, net_depth=2, net_width=32),
              fov=fov, nt=8, span_M=200.0, batch=4, seed=0, lr=1e-3)
    alma_cfg = dict(model=model, predictor=dict(net_depth=2, net_width=32,
                                                learn_injection=True),
                    rot_angle=0.0, sigma=[0.15, 0.01, 0.01], nt=8, seed=0)
    trace = {'t3': dict(kw, alpha=alpha, beta=beta),
             'alma': dict(alma_kw, alpha=a_alpha, beta=a_beta)}
    config = drive.write_config(str(tmp_path), geos, alma_geos, t3,
                                alma_cfg, trace, ('1x2',), 10, 5)
    cfg = json.loads((tmp_path / 'config.json').read_text())
    ref = drive.one_process(cfg, cuda_device)

    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WORLD_SIZE='2', LOCAL_RANK='0',
               MASTER_ADDR='localhost', MASTER_PORT=str(port),
               PYTHONPATH=repo)
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'bhnerf_tpu_torch.scripts.drive_multigpu',
         '--config', config, '--backend', 'gloo', '--device', 'cuda:0'],
        env=dict(env, RANK=str(r)), cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    records = [json.loads((tmp_path / f'rank_{r}.json').read_text())
               for r in range(2)]
    arrays = [np.load(tmp_path / f'rank_{r}.npz') for r in range(2)]

    for k, table in ref['tables'].items():
        for f in drive.TABLE_FIELDS:
            np.testing.assert_array_equal(arrays[0][f'trace/{k}/{f}'],
                                          np.asarray(getattr(table, f)))
    images, loss, grads = ref['step'][:3]
    close = lambda a, b, rtol: np.testing.assert_allclose(
        a, b, rtol=rtol, atol=1e-6 * np.abs(b).max())
    close(arrays[0]['1x2/images'], images, 2e-5)
    close(float(arrays[0]['1x2/loss']), loss, 2e-5)
    for k, g in grads.items():
        close(arrays[0][f'1x2/grad/{k}'], g, 2e-4)
        np.testing.assert_array_equal(arrays[1][f'1x2/grad/{k}'],
                                      arrays[0][f'1x2/grad/{k}'])
    n_params = sum(g.size for g in grads.values())
    for r in records:
        assert r['census']['1x2/forward'] == {
            'image over ray': {'count': 1, 'largest': images.size}}
        assert r['census']['1x2/step'] == {
            'image over ray': {'count': 1, 'largest': images.size},
            'grad over ray': {'count': 1, 'largest': n_params}}
        assert min(r['launches'].values()) > 0, r['launches']
        assert r['checkpoints']['restored_step'] == 4


def _thin_volume(n=32, seed=1):
    """A seeded hotspot-like volume: a Gaussian blob times noise."""
    g = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(g, g, g, indexing='ij')
    blob = np.exp(-((x - 0.3) ** 2 + y ** 2 + (z * 3) ** 2) / 0.05)
    noise = np.random.default_rng(seed).random((n,) * 3)
    return (0.05 * blob * noise).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize('draw_cube,bh_radius', [(False, None), (True, 2.0)])
def test_volume_compositors_on_card_match_cpu(cuda_device, draw_cube,
                                              bh_radius):
    """The two volume compositors on the card against the same calls on
    the CPU (a seeded 32^3 volume, 64x64 pixels, 96 samples):
    VolumeVisualizer.composite's four layers and _transfer_composite's
    intensity and alpha, each within 2e-4 of its maximum (the bound of
    tests/test_torch_visualization.py against the JAX package)."""
    from bhnerf_tpu_torch import visualization as vis
    vol = _thin_volume()
    kw = dict(extent=8.0, azimuth=0.8, zenith=np.pi / 3, sigma_scale=300.0,
              bh_radius=bh_radius, draw_cube=draw_cube)
    layers = [vis.VolumeVisualizer((64, 64), fov=35.0, samples=96,
                                   device=device).composite(vol, **kw)
              for device in ('cpu', cuda_device)]
    cam, dirs = vis.VolumeVisualizer((64, 64), fov=45.0, device='cpu')._rays(
        0.0, np.deg2rad(150.0), 40.0)
    ts = torch.linspace(11.2, 68.8, 96)
    nodes = (torch.tensor([0.0, 0.2, 0.7]), torch.tensor([0.0, 0.2, 0.3]))
    transfer = [[x.cpu().numpy() for x in vis._transfer_composite(
        torch.as_tensor(vol).to(device), float(vol.max()), cam.to(device),
        dirs.to(device), ts.to(device), 0.6, 8.0,
        *(node.to(device) for node in nodes))]
        for device in ('cpu', cuda_device)]
    for cpu, card in zip(layers[0] + tuple(transfer[0]),
                         layers[1] + tuple(transfer[1])):
        assert card.shape == cpu.shape and np.isfinite(card).all()
        scale = np.abs(cpu).max()
        np.testing.assert_allclose(card, cpu, rtol=0,
                                   atol=2e-4 * scale if scale else 0.0)
    assert layers[0][0].max() > 0


@pytest.mark.cuda
def test_bench_sections_on_card(cuda_device, tmp_path, monkeypatch):
    """Each section of bhnerf_tpu_torch.bench small on the card (a 16x16
    x32 host table cached under tmp_path, one rep): one forward and one
    backward launch of the fused kernels a fused step (the warm-up step or
    chunk included), none in the device trace and the plain baseline, two
    tracer launches; the sections' keys make one JSON-able dict of
    finite numbers, the MFU keys set for a card in PEAK_FLOPS."""
    from bhnerf_tpu_torch import bench
    from bhnerf_tpu_torch.geodesics import integrator
    monkeypatch.setattr(bench, 'CACHE_DIR', str(tmp_path))
    monkeypatch.setenv('BENCH_REPS', '1')
    p = bench.headline_problem(cuda_device, num=16, ngeo=32, nt=16,
                               n_fine=1024)
    t_eht = np.linspace(4.0, 15.5, p.nt).astype(np.float32)
    sections = {
        'per_dispatch': (lambda: bench.bench_per_dispatch(p, n_steps=3),
                         4),
        'scan': (lambda: bench.bench_scan(p, chunk=4, steps=8), 12),
        'alma_shape': (lambda: bench.bench_alma_shape(
            p.predictor, bench.mark, num_variants=2, chunk=4,
            device=cuda_device, num=16, ngeo=16, nt=16, steps=4), 8),
        'eht_step': (lambda: bench.bench_eht_step(
            p.predictor, p.geos, p.rt, p.crt, t_eht, bench.mark, chunk=4,
            n_chunks=1, device=cuda_device), 16),
        'device_geos': (lambda: bench.bench_device_geos(
            bench.mark, n=8, ngeo=16, n_fine=512, device=cuda_device), 0),
        'dense_baseline': (lambda: bench.bench_dense_baseline(
            p, bench.mark, n_steps=2), 0)}
    line = {}
    for name, (run, steps) in sections.items():
        fused.render_fwd.launches = fused.render_bwd.launches = 0
        integrator.trace_rays.launches = 0
        out = run()
        torch.cuda.synchronize()
        assert (fused.render_fwd.launches, fused.render_bwd.launches) == \
            (steps, steps), name
        assert integrator.trace_rays.launches == (
            2 if name == 'device_geos' else 0), name
        # (steps/s, loss or rates) of the timed sections: their rate
        line.update(out if isinstance(out, dict) else
                    {name: out[0] if isinstance(out, tuple) else out})
    assert json.loads(json.dumps(line)) == line
    numbers = [np.asarray(v, float) for v in line.values()
               if v is not None]
    assert all(np.isfinite(v).all() for v in numbers)
    if bench.card_info(cuda_device)['chip'] in bench.PEAK_FLOPS:
        assert line['alma_mfu'] > 0
    assert line['eht_nvis_per_frame'] > 0 and line['alma_shape'] == \
        [16, 16, 16, 3]
