"""Port parity: the fused render of bhnerf_tpu_torch against bhnerf_tpu.

On the CPU the port's kernel wrappers run their plain PyTorch versions;
the JAX side runs its Pallas kernels in interpret mode, as its own tests
do. Inputs are made once with numpy and handed to both packages; the JAX
parameters are copied into the port with params_from_jax. Tests that need
the card are in test_torch_cuda.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bhnerf_tpu import units as j_units
from bhnerf_tpu.geodesics import image_plane_geos
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.ops import fused as j_fused
from bhnerf_tpu.train import raytracing_args as j_raytracing_args
from bhnerf_tpu.train.step import predict_emission as j_predict_emission

from bhnerf_tpu_torch import units
from bhnerf_tpu_torch.geodesics.dataset import Geodesics
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.ops import fused
from bhnerf_tpu_torch.train.step import predict_emission, raytracing_args

PRED_KW = dict(scale=8.0, rmin=3.0, rmax=8.0, z_width=2.0, net_depth=4,
               net_width=32, posenc_deg=3)
T_FRAMES = np.asarray([0.0, 40.0, 90.0], np.float32)


def to_torch_geos(geos):
    return Geodesics(**{f: np.asarray(getattr(geos, f))
                        for f in Geodesics._FIELDS + Geodesics._AUX})


def torch_params(predictor, jparams):
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return predictor.params_from_jax(np_params, device='cpu')


def jax_grads_as_torch(g):
    """JAX dense_i/{kernel (in, out), bias} -> [(weight (out, in), bias)]."""
    return [(np.asarray(g[f'dense_{i}']['kernel']).T,
             np.asarray(g[f'dense_{i}']['bias']))
            for i in range(sum(k.startswith('dense_') for k in g))]


def torch_grads(params):
    return [(l.weight.grad.numpy(), l.bias.grad.numpy())
            for l in params.mlp.layers]


@pytest.fixture(scope='module')
def setup():
    geos = image_plane_geos(spin=0.0, inclination=np.deg2rad(60),
                            alpha_range=(-8, 8), beta_range=(-8, 8),
                            ngeo=16, num_alpha=8, num_beta=8, n_fine=1024)
    t_inj = -float(geos.r_o + 4)
    j_rt = j_raytracing_args(geos, geos.keplerian_omega(), t_inj,
                             j_units.Quantity(0.0, 'hr'))
    tgeos = to_torch_geos(geos)
    rt = raytracing_args(tgeos, tgeos.keplerian_omega(), t_inj,
                         units.Quantity(0.0, 'hr'), device='cpu')
    return j_rt, rt


def test_predict_emission_matches_jax(setup):
    """Plain warp + posenc + MLP emission (step.predict_emission); the
    tolerance of the reference's fused-vs-XLA test (test_fused.py:41)."""
    j_rt, rt = setup
    jpred, pred = JPredictor(**PRED_KW), NeRFPredictor(**PRED_KW)
    jparams = jpred.init_params(seed=0)
    params = torch_params(pred, jparams)
    ref = np.asarray(j_predict_emission(jparams, jpred,
                                        jnp.asarray(T_FRAMES), j_rt))
    with torch.no_grad():
        out = predict_emission(params, pred, torch.as_tensor(T_FRAMES),
                               rt).numpy()
    assert out.shape == ref.shape == (3, 8, 8, 16)
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=1e-4)


@pytest.mark.parametrize('kw', [
    {},
    # a non-default architecture: no skip, depth 2 (test_fused.py:70-80)
    dict(net_depth=2, net_width=16, posenc_deg=2, do_skip=False, rmin=0.0),
], ids=['depth4_skip', 'depth2_noskip'])
def test_fused_forward_matches_jax(setup, kw):
    """The forward kernel's plain version against the Pallas kernel in
    interpret mode: atol 2e-6, rtol 1e-4 (test_fused.py:41)."""
    j_rt, rt = setup
    jpred = JPredictor(**{**PRED_KW, **kw})
    pred = NeRFPredictor(**{**PRED_KW, **kw})
    jparams = jpred.init_params(seed=2)
    params = torch_params(pred, jparams)
    ref = np.asarray(j_fused.predict_emission_fused(
        jparams, jpred, jnp.asarray(T_FRAMES), j_rt))
    with torch.no_grad():
        out = fused.predict_emission_fused(
            params, pred, torch.as_tensor(T_FRAMES), rt).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=1e-4)


def _loss_and_grads_jax(jpred, jparams, j_rt, target, use_fused):
    def loss(p):
        em = (j_fused.predict_emission_fused(p, jpred, jnp.asarray(T_FRAMES),
                                             j_rt)
              if use_fused else
              j_predict_emission(p, jpred, jnp.asarray(T_FRAMES), j_rt))
        return jnp.sum((em - jnp.asarray(target)) ** 2)
    return jax.value_and_grad(loss)(jparams)


def _loss_and_grads_torch(pred, params, rt, target):
    em = fused.predict_emission_fused(params, pred,
                                      torch.as_tensor(T_FRAMES), rt)
    loss = torch.sum((em - torch.as_tensor(target)) ** 2)
    loss.backward()
    return float(loss.detach())


def test_fused_gradients_match_jax(setup):
    """Backward kernel's plain version against the Pallas backward:
    loss rtol 1e-5, gradients atol 5e-5 after normalising by the max
    (test_fused.py:59-67)."""
    j_rt, rt = setup
    jpred, pred = JPredictor(**PRED_KW), NeRFPredictor(**PRED_KW)
    jparams = jpred.init_params(seed=0)
    params = torch_params(pred, jparams)
    target = np.random.default_rng(0).random((3, 8, 8, 16)).astype(
        np.float32)
    l_ref, g_ref = _loss_and_grads_jax(jpred, jparams, j_rt, target, True)
    l_t = _loss_and_grads_torch(pred, params, rt, target)
    np.testing.assert_allclose(l_t, float(l_ref), rtol=1e-5)
    for i, ((wr, br), (wt, bt)) in enumerate(
            zip(jax_grads_as_torch(g_ref), torch_grads(params))):
        for a, b in ((wr, wt), (br, bt)):
            scale = np.abs(a).max() + 1e-8
            np.testing.assert_allclose(b / scale, a / scale, atol=5e-5,
                                       err_msg=f'dense_{i}')


def test_fused_learn_injection_grad_matches_jax(setup):
    """want_dt: the backward's frame-time cotangent gives the learnable
    injection offset's gradient; held against the JAX path with learned
    injection at rtol 2e-3, MLP gradients at 5e-5 after normalising
    (test_fused.py:170-211)."""
    j_rt, rt = setup
    jpred = JPredictor(**PRED_KW, learn_injection=True)
    pred = NeRFPredictor(**PRED_KW, learn_injection=True)
    jparams = jpred.init_params(seed=1)
    # boost the output layer so emission has macroscopic structure
    jparams['dense_4']['bias'] = jparams['dense_4']['bias'] + 9.0
    jparams['t_injection'] = jnp.float32(3.0)
    params = torch_params(pred, jparams)
    target = np.random.default_rng(2).random((3, 8, 8, 16)).astype(
        np.float32)
    l_x, g_x = _loss_and_grads_jax(jpred, jparams, j_rt, target, False)
    l_t = _loss_and_grads_torch(pred, params, rt, target)
    np.testing.assert_allclose(l_t, float(l_x), rtol=1e-5)
    gt_x = float(np.asarray(g_x['t_injection']))
    gt_t = float(params.t_injection.grad)
    assert abs(gt_x) > 1e-4, 'degenerate test: zero warp gradient'
    np.testing.assert_allclose(gt_t, gt_x, rtol=2e-3)
    for i, ((wr, _), (wt, _)) in enumerate(
            zip(jax_grads_as_torch(g_x), torch_grads(params))):
        scale = np.abs(wr).max() + 1e-8
        np.testing.assert_allclose(wt / scale, wr / scale, atol=5e-5,
                                   err_msg=f'dense_{i}')


def test_fused_bf16_close_to_f32_jax(setup):
    """compute_dtype='bfloat16' (bf16 operands, f32 sums) stays close to
    the f32 JAX reference: loss within 2%, per-matrix gradient cosine
    > 0.99 (test_fused.py:83-114)."""
    j_rt, rt = setup
    jpred = JPredictor(**PRED_KW)
    pred = NeRFPredictor(**PRED_KW, compute_dtype='bfloat16')
    jparams = jpred.init_params(seed=0)
    params = torch_params(pred, jparams)
    target = np.random.default_rng(1).random((3, 8, 8, 16)).astype(
        np.float32)
    l_ref, g_ref = _loss_and_grads_jax(jpred, jparams, j_rt, target, False)
    l_b = _loss_and_grads_torch(pred, params, rt, target)
    np.testing.assert_allclose(l_b, float(l_ref), rtol=0.02)
    for (wr, br), (wb, bb) in zip(jax_grads_as_torch(g_ref),
                                  torch_grads(params)):
        for a, b in ((wr, wb), (br, bb)):
            a, b = a.ravel(), b.ravel()
            denom = np.linalg.norm(a) * np.linalg.norm(b)
            if denom > 1e-12:
                assert float(a @ b / denom) > 0.99


def test_fused_rejects_unexpected_param_leaf():
    """A parameter outside the MLP (other than t_injection) would get a
    silent zero gradient from the fused backward: refused with ValueError
    (reference fused.py:522-529)."""
    pred = NeRFPredictor(scale=8.0, net_width=16, net_depth=2)
    params = pred.init_params(generator=torch.Generator().manual_seed(0),
                              device='cpu')
    params.register_parameter('extra', torch.nn.Parameter(torch.zeros(3)))
    n = fused.TILE_N
    with pytest.raises(ValueError, match='extra'):
        fused.render_samples(params, pred, torch.zeros(1),
                             torch.zeros(3, n), 0.02, torch.zeros(n), 0.0)


def test_fused_injection_leaf_gets_zero_cotangent():
    """With learn_injection params but a constant injection time, the
    offset leaf's own cotangent is zero, not missing (test_fused.py:117)."""
    pred = NeRFPredictor(scale=8.0, net_width=16, net_depth=2,
                         learn_injection=True)
    params = pred.init_params(generator=torch.Generator().manual_seed(0),
                              device='cpu')
    n = fused.TILE_N
    em = fused.render_samples(params, pred, torch.zeros(1),
                              torch.zeros(3, n), torch.full((n,), 0.02),
                              torch.zeros(n), 0.0)
    em.sum().backward()
    assert params.t_injection.grad is not None
    assert float(params.t_injection.grad) == 0.0
    assert params.mlp.layers[0].weight.grad is not None


@pytest.mark.parametrize('width,ok', [(128, True), (16, True), (144, False),
                                      (24, False)])
def test_cuda_input_check_widths(width, ok):
    """The kernels take widths that are multiples of 16 up to MAX_WIDTH as
    they are (ok); the wrappers pad another width up to the next multiple
    of 16 and refuse, before any launch, a width whose padding exceeds
    MAX_WIDTH. The backward has no row limit besides its shared memory."""
    n = fused.TILE_N
    fused._check_cuda_inputs([torch.zeros(3, n), torch.zeros(1, n)], n)
    cfg = (4, width, True)
    params = NeRFPredictor(scale=8.0, net_depth=4, net_width=width) \
        .init_params(device='cpu')
    weights, biases = fused.pack_params(params)
    if width > fused.MAX_WIDTH:
        with pytest.raises(ValueError, match='net_width'):
            fused._pad_width(weights, biases, cfg)
        return
    _, _, cfg_p = fused._pad_width(weights, biases, cfg)
    assert cfg_p == (4, -(-width // 16) * 16, True)
    assert (cfg_p == cfg) == ok


def test_kernel_limits_match_source():
    """TILE_N and MAX_WIDTH stay in step with fused_render.cu: the tile
    is the backward's BN (the forward's is a multiple of it and masks its
    own tail), and the forward takes one 32-row unit of output per group
    of warps."""
    src = (Path(fused.__file__).parent / 'csrc' / 'fused_render.cu') \
        .read_text()
    const = lambda name: int(re.search(
        rf'constexpr int {name} = (\d+);', src).group(1))
    assert const('BN') == fused.TILE_N
    assert const('FWD_BN') % fused.TILE_N == 0
    assert 'width <= 16 * FWD_MT * FWD_MAX_MU' in src
    groups = const('FWD_THREADS') // 32 // (const('FWD_BN')
                                            // (8 * const('FWD_NT')))
    assert fused.MAX_WIDTH == 16 * const('FWD_MT') * groups


def test_forward_argtypes_match_source():
    """The ctypes signature the wrapper gives `fused_render_fwd` stays in
    step with its C prototype in fused_render.cu: pointers (the scratch
    for the reordered weights included) as void pointers, ints as ints,
    the one float as a float."""
    import ctypes
    src = (Path(fused.__file__).parent / 'csrc' / 'fused_render.cu') \
        .read_text()
    proto = re.search(r'int fused_render_fwd\((.*?)\)\s*{', src, re.S).group(1)
    kinds = []
    for param in proto.split(','):
        param = ' '.join(param.split())
        kinds.append(ctypes.c_void_p if '*' in param
                     else {'int': ctypes.c_int,
                           'float': ctypes.c_float}[param.split()[0]])
    assert kinds == fused.FWD_ARGTYPES
    assert 'float* wf' in proto


def test_backward_argtypes_match_source():
    """The ctypes signature the wrapper gives `fused_render_bwd` stays in
    step with its C prototype in fused_render.cu, the activation stash
    after the features."""
    import ctypes
    src = (Path(fused.__file__).parent / 'csrc' / 'fused_render.cu') \
        .read_text()
    proto = re.search(r'int fused_render_bwd\((.*?)\)\s*{', src, re.S).group(1)
    kinds = [ctypes.c_void_p if '*' in p else ctypes.c_int
             for p in (' '.join(q.split()) for q in proto.split(','))]
    assert kinds == fused.BWD_ARGTYPES
    assert [' '.join(q.split()) for q in proto.split(',')][2:4] == \
        ['const float* fstash', 'const float* h_store']


def _plain_inputs(depth, width, do_skip, compute_dtype, nt=3, seed=0):
    rng = np.random.default_rng(seed)
    n = 2 * fused.TILE_N
    pred = NeRFPredictor(scale=8.0, net_depth=depth, net_width=width,
                         do_skip=do_skip, compute_dtype=compute_dtype)
    params = pred.init_params(generator=torch.Generator().manual_seed(seed),
                              device='cpu')
    weights = [w.detach() for w in fused.pack_params(params)[0]]
    biases = [b.detach() + 0.3 for b in fused.pack_params(params)[1]]
    biases[-1] = biases[-1] + 8.0
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    common = (f32(rng.uniform(0, 50, (nt, 1))),
              f32(rng.uniform(-8, 8, (3, n))),
              f32(rng.uniform(0.01, 0.1, (1, n))),
              f32(rng.uniform(-30, 30, (1, n))),
              f32(rng.random((1, n)) > 0.2))
    g = f32(rng.standard_normal((nt, n)))
    return common, weights, biases, (depth, width, do_skip), g


@pytest.mark.parametrize('compute_dtype,depth,width,do_skip,want_dt', [
    ('float32', 4, 32, True, False), ('float32', 4, 32, True, True),
    ('bfloat16', 4, 32, True, True), ('float32', 2, 16, False, True),
    ('float32', 8, 48, True, True)])
def test_plain_backward_from_stash_matches_recompute(compute_dtype, depth,
                                                     width, do_skip,
                                                     want_dt):
    """render_bwd_plain gives bitwise the same gradients and d_t from the
    activations render_fwd_plain stashes (H (depth, width, nt * N), each
    layer's output after bias, ReLU and rounding) as from its own
    recompute, and from an H padded with zero rows past the width."""
    common, weights, biases, cfg, g = _plain_inputs(depth, width, do_skip,
                                                    compute_dtype)
    em, F, H = fused.render_fwd_plain(*common, weights, biases, cfg, 8.0, 3,
                                      compute_dtype, stash=True)
    assert H.shape == (depth, width, F.shape[1])
    acts, _ = fused._forward_chain_plain(F, weights, biases, cfg,
                                         compute_dtype == 'bfloat16')
    for h, a in zip(H, acts):
        assert torch.equal(h, a[:width])
    bwd = (g, em, F, common[2], weights, biases, cfg, 3, compute_dtype,
           want_dt)
    ref = fused.render_bwd_plain(*bwd)
    padded = torch.nn.functional.pad(H, (0, 0, 0, 16))
    for stash in (H, padded):
        got = fused.render_bwd_plain(*bwd, stash)
        assert all(torch.equal(a, b) for a, b in
                   zip(ref[0] + ref[1] + [ref[2]], got[0] + got[1] + [got[2]]))


def test_fused_step_runs_the_mlp_forward_once(monkeypatch):
    """Through the autograd Function a gradient step evaluates the MLP's
    hidden layers once: the backward takes the activations the forward
    stashed. Its gradients equal those of the backward that recomputes
    them (bitwise on the CPU)."""
    common, weights, biases, cfg, g = _plain_inputs(4, 32, True, 'float32')
    t_eff, coords, omega, tg, smask = common
    pred = NeRFPredictor(scale=8.0, net_depth=4, net_width=32)
    chain = fused._forward_chain_plain
    calls = []
    monkeypatch.setattr(fused, '_forward_chain_plain',
                        lambda *a: calls.append(1) or chain(*a))
    grads = []
    for stash in (True, False):
        params = pred.init_params(generator=torch.Generator().manual_seed(0),
                                  device='cpu')
        if not stash:     # a forward that kept no activations
            fwd = fused.render_fwd
            monkeypatch.setattr(
                fused, 'render_fwd',
                lambda *a, **k: (fwd(*a, **k)[:2] + (None,))
                if k.get('stash') else fwd(*a, **k))
        calls.clear()
        em = fused.fused_render(params, coords, omega, tg, smask, t_eff, cfg,
                                8.0, 3)
        (em * g).sum().backward()
        assert len(calls) == (1 if stash else 2)
        grads.append([p.grad for p in params.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# an 80 GB card; the stash's budget is an eighth of it, 10 GB
CARD_BYTES = 80 * 10 ** 9


@pytest.mark.parametrize('name,nt,n,fits', [
    ('tutorial-3 step', 6, 68_352, True),           # 0.84 GB
    ('ALMA gather', 6, 47_488, True),               # 0.58 GB
    ('bench ALMA shape', 6, 277_632, True),         # 3.4 GB
    ('EHT npix 128', 6, 422_080, True),             # 5.2 GB
    ('EHT npix 128, 12 frames', 12, 422_080, False),   # 10.4 GB
    ('EHT npix 128, 64 frames', 64, 422_080, False)])  # 55 GB
def test_activation_stash_budget(name, nt, n, fits):
    """The wrapper stashes the 4x128 MLP's hidden activations (4 B x 4 x
    128 a column) while they fit an eighth of the card's total memory,
    and recomputes them above it: every training shape of the port takes
    the stash on an 80 GB card; the shape alone decides."""
    assert fused.ACT_STASH_SHARE == 1 / 8
    assert fused.act_stash_fits(4, 128, nt * n, CARD_BYTES) == fits
    assert fused.act_stash_fits(4, 128, nt * n, 8 * CARD_BYTES)
