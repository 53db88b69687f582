"""Port parity: the fused render of bhnerf_tpu_torch against bhnerf_tpu.

On the CPU the port's kernel wrappers run their plain PyTorch versions;
the JAX side runs its Pallas kernels in interpret mode, as its own tests
do. Inputs are made once with numpy and handed to both packages; the JAX
parameters are copied into the port with params_from_jax. Tests that need
the card are in test_torch_cuda.py.
"""
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
    return predictor.params_from_jax(np_params)


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
                         units.Quantity(0.0, 'hr'))
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
    params = pred.init_params(generator=torch.Generator().manual_seed(0))
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
    params = pred.init_params(generator=torch.Generator().manual_seed(0))
    n = fused.TILE_N
    em = fused.render_samples(params, pred, torch.zeros(1),
                              torch.zeros(3, n), torch.full((n,), 0.02),
                              torch.zeros(n), 0.0)
    em.sum().backward()
    assert params.t_injection.grad is not None
    assert float(params.t_injection.grad) == 0.0
    assert params.mlp.layers[0].weight.grad is not None
