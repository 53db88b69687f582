"""Port parity: domain compaction (both layouts, unpolarized), the per-pixel
reduction, the image loss, Adam and the training loop of bhnerf_tpu_torch
against bhnerf_tpu. The polarized lightcurve path is in test_torch_alma.py.

Small sizes (8x8 rays, ngeo 16, width 32); inputs from numpy seeds, JAX
parameters copied in with params_from_jax, frame indices passed
explicitly. On the CPU the fused path runs the kernels' plain versions.
"""
import dataclasses
import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from bhnerf_tpu import units as j_units
from bhnerf_tpu.geodesics import image_plane_geos
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.train import TrainState as JTrainState
from bhnerf_tpu.train import make_optimizer as j_make_optimizer
from bhnerf_tpu.train import raytracing_args as j_raytracing_args
from bhnerf_tpu.train import step as j_step

from bhnerf_tpu_torch import alma, emission, units, visualization
from bhnerf_tpu_torch.examples import (recovery_animation,
                                       selfcal_known_corruption)
from bhnerf_tpu_torch.geodesics.dataset import Geodesics
from bhnerf_tpu_torch.models import fields
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.ops import fused
from bhnerf_tpu_torch.train import step
from bhnerf_tpu_torch.train.optimizer import (LogFn, Optimizer,
                                              TemporalBatchedArgs, TrainStep)
from bhnerf_tpu_torch.train.state import TrainState, make_optimizer
from bhnerf_tpu_torch.tutorials import (
    tutorial1_kerr_geodesics as t1,
    tutorial2_synthesize_ngeht_observations as t2,
    tutorial3_estimate_emission_image_plane as t3,
    tutorial4_estimate_emission_eht as t4,
    tutorial5_visualize_recovery as t5)

PRED_KW = dict(scale=8.0, rmin=3.0, rmax=8.0, z_width=2.0, net_depth=4,
               net_width=32, posenc_deg=3)
T_FRAMES = np.asarray([0.0, 50.0, 120.0], np.float32)
TILE = fused.TILE_N


@pytest.fixture(scope='module')
def setup():
    geos = image_plane_geos(spin=0.0, inclination=np.deg2rad(60),
                            alpha_range=(-8, 8), beta_range=(-8, 8),
                            ngeo=16, num_alpha=8, num_beta=8, n_fine=1024)
    t_inj = -float(geos.r_o + 4)
    j_rt = j_raytracing_args(geos, geos.keplerian_omega(), t_inj,
                             j_units.Quantity(0.0, 'hr'))
    tgeos = Geodesics(**{f: np.asarray(getattr(geos, f))
                         for f in Geodesics._FIELDS + Geodesics._AUX})
    rt = step.raytracing_args(tgeos, tgeos.keplerian_omega(), t_inj,
                              units.Quantity(0.0, 'hr'), device='cpu')
    jpred, pred = JPredictor(**PRED_KW), NeRFPredictor(**PRED_KW)
    jparams = jpred.init_params(seed=0)
    # lift the head so the emission (and its gradients) is macroscopic
    jparams['dense_4']['bias'] = jparams['dense_4']['bias'] + 8.0
    j_crt = j_step.compact_raytracing_args(j_rt, jpred, tile=TILE)
    crt = step.compact_raytracing_args(rt, pred)
    # the reference computes the Doppler factor in f32 and the port in
    # f64; hand the reference the port's weights so that the steps below
    # start from identical inputs
    j_crt_same = dataclasses.replace(
        j_crt, weights=jnp.asarray(crt.weights.numpy()),
        red_weights=jnp.asarray(crt.red_weights.numpy()))
    return dict(j_rt=j_rt, rt=rt, jpred=jpred, pred=pred, jparams=jparams,
                j_crt=j_crt, crt=crt, j_crt_same=j_crt_same)


def torch_params(s):
    return s['pred'].params_from_jax(
        jax.tree_util.tree_map(np.asarray, s['jparams']), device='cpu')


@pytest.mark.parametrize('field', ['coords', 'Omega', 'weights',
                                   't_geos_rel', 'pixel_ids', 'red_gather',
                                   'red_weights', 'red_group_ids'])
def test_compact_layout_matches_jax(setup, field):
    """compact_raytracing_args in the 'gather' layout is the reference's
    host numpy: the same samples, pads and reduction tables, exactly; the
    weights carry the Doppler factor, f64 in the port and f32 in the
    reference, hence rtol 1e-5 there."""
    a = np.asarray(getattr(setup['j_crt'], field))
    b = getattr(setup['crt'], field).numpy()
    assert a.shape == b.shape
    if field in ('weights', 'red_weights'):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(b, a.astype(b.dtype))


@pytest.mark.parametrize('field', ['coords', 'Omega', 'weights',
                                   't_geos_rel', 'pixel_ids',
                                   'red_group_ids'])
def test_native_layout_matches_jax(setup, field):
    """compact_raytracing_args(layout='native') with scalar-J weights is
    the reference's host numpy: the same k-major slots and fillers,
    exactly; the weights to rtol 1e-5 (f64-vs-f32 Doppler factor)."""
    j_nat = j_step.compact_raytracing_args(setup['j_rt'], setup['jpred'],
                                           tile=TILE, layout='native')
    nat = step.compact_raytracing_args(setup['rt'], setup['pred'],
                                       layout='native')
    assert nat.red_gather is None and nat.red_weights is None
    assert j_nat.red_gather is None and not nat.polarized
    a, b = np.asarray(getattr(j_nat, field)), getattr(nat, field).numpy()
    assert a.shape == b.shape
    if field == 'weights':
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(b, a.astype(b.dtype))


def test_native_layout_images_match_gather(setup):
    """The two layouts render the same unpolarized images and parameter
    gradients through the fused path: loss rtol 2e-5, gradients rtol 5e-4
    / atol 5e-7 (test_compact.py:236-246)."""
    s = setup
    nat = step.compact_raytracing_args(s['rt'], s['pred'], layout='native')
    assert nat.coords.shape[-1] >= s['crt'].coords.shape[-1]
    results = []
    for crt in (nat, s['crt']):
        params = torch_params(s)
        img = step.image_plane_prediction(params, s['pred'],
                                          torch.as_tensor(T_FRAMES), crt,
                                          fused=True)
        assert tuple(img.shape) == (3, 8, 8)
        loss = torch.sum(img ** 2)
        loss.backward()
        results.append((float(loss.detach()),
                        [l.weight.grad.numpy() for l in params.mlp.layers]))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=2e-5)
    for a, b in zip(results[0][1], results[1][1]):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-7)


def test_compact_images_match_jax(setup):
    """Compact fused images against the reference's compact fused images
    (Pallas interpret mode): atol 2e-6 / rtol 1e-4 per pixel, after
    normalising by the max."""
    s = setup
    ref = np.asarray(j_step.image_plane_prediction(
        s['jparams'], s['jpred'], jnp.asarray(T_FRAMES), s['j_crt'],
        fused=True))
    with torch.no_grad():
        out = step.image_plane_prediction(
            torch_params(s), s['pred'], torch.as_tensor(T_FRAMES), s['crt'],
            fused=True).numpy()
    assert out.shape == ref.shape == (3, 8, 8)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-6,
                               rtol=1e-4)


def test_compact_matches_dense(setup):
    """Compacted fused images and their gradients equal the dense plain
    pipeline's (test_compact.py:50,79-84): images atol 2e-5 after
    normalising, loss rtol 1e-4, gradients atol 1e-4 normalised."""
    s = setup
    target = torch.as_tensor(np.random.default_rng(0).random((3, 8, 8)),
                             dtype=torch.float32)
    results = []
    for rt, use_fused in ((s['rt'], False), (s['crt'], True)):
        params = torch_params(s)
        img = step.image_plane_prediction(params, s['pred'],
                                          torch.as_tensor(T_FRAMES), rt,
                                          fused=use_fused)
        loss = torch.sum((img - target) ** 2)
        loss.backward()
        results.append((img.detach().numpy(), float(loss.detach()),
                        [p.grad.numpy() for p in params.parameters()]))
    (img_d, l_d, g_d), (img_c, l_c, g_c) = results
    scale = np.abs(img_d).max()
    np.testing.assert_allclose(img_c / scale, img_d / scale, atol=2e-5)
    np.testing.assert_allclose(l_c, l_d, rtol=1e-4)
    for a, b in zip(g_d, g_c):
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-4)


def test_grouped_reduce_matches_segment_sum(setup):
    """The grouped reduction and its gather-adjoint backward equal the
    plain segment sum in values and input gradients (f32 reassociation)."""
    crt = setup['crt']
    n = crt.coords.shape[-1]
    em0 = torch.as_tensor(np.random.default_rng(1).random((3, n)),
                          dtype=torch.float32)
    w_img = torch.as_tensor(np.random.default_rng(2).random((3, 1, 64)),
                            dtype=torch.float32)
    outs = []
    for reduce in (lambda em: step._reduce_to_images(em, crt),
                   lambda em: step._segment_reduce(crt.npix, em,
                                                   crt.pixel_ids,
                                                   crt.weights)):
        em = em0.clone().requires_grad_(True)
        img = reduce(em)
        (img * w_img).sum().backward()
        outs.append((img.detach().numpy(), em.grad.numpy()))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-5, atol=1e-7)


def test_polynomial_schedule_matches_optax():
    tx = make_optimizer(num_iters=7, lr_init=1e-3, lr_final=1e-5)
    sched = optax.polynomial_schedule(1e-3, 1e-5, 1, 7)
    for count in range(10):
        np.testing.assert_allclose(tx.lr(count), float(sched(count)),
                                   rtol=1e-6)


def test_adam_steps_match_jax(setup):
    """Four grad steps with the same frame indices and the same initial
    params reach the same params: the port's fused compact step (plain
    kernels on the CPU) against the reference's gather-in-jit step.
    Tolerance atol 2e-5, 5% of the most a parameter can move in four
    updates of lr 1e-4: Adam divides m by sqrt(v) per element, so where a
    gradient changes sign between steps m nearly cancels, and the f32
    reassociation differences of the two gradients (up to ~1e-3 relative
    on entries 1e-4 of the largest) show at that scale."""
    s = setup
    nt = 8
    rng = np.random.default_rng(3)
    target = rng.random((nt, 8, 8)).astype(np.float32)
    t_frames = np.linspace(0.0, 0.3, nt).astype(np.float32)
    indices = [rng.choice(nt, 3, replace=False) for _ in range(4)]
    sigma, offset = np.ones_like(target), np.zeros_like(target)

    j_state = JTrainState.create(s['jparams'], j_make_optimizer(
        num_iters=10, lr_init=1e-4, lr_final=1e-5))
    j_grad, _ = j_step.make_step_fns(s['jpred'], kind='image', dtype='full',
                                     fused=False, gather=True)
    for idx in indices:
        j_loss, j_state, _ = j_grad(
            j_state, jnp.asarray(target), jnp.asarray(sigma),
            jnp.asarray(offset), jnp.asarray(t_frames),
            jnp.asarray(idx, jnp.int32), s['j_crt_same'], 1.0)

    state = TrainState.create(torch_params(s), make_optimizer(
        num_iters=10, lr_init=1e-4, lr_final=1e-5))
    grad, _ = step.make_step_fns(s['pred'], dtype='full', fused=True)
    tt = lambda x: torch.as_tensor(x)
    for idx in indices:
        loss, state, _ = grad(state, tt(target), tt(sigma), tt(offset),
                              tt(t_frames), tt(idx), s['crt'], 1.0)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    assert state.step == 4
    moved = 0.0
    for i, layer in enumerate(state.params.mlp.layers):
        jp = j_state.params[f'dense_{i}']
        j0 = s['jparams'][f'dense_{i}']
        moved = max(moved, float(np.abs(np.asarray(jp['kernel'])
                                        - np.asarray(j0['kernel'])).max()))
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   np.asarray(jp['kernel']).T, atol=2e-5)
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   np.asarray(jp['bias']), atol=2e-5)
    assert moved > 2e-4, 'degenerate test: the parameters did not move'


def test_optimizer_run_lowers_loss_on_cpu(setup):
    """Optimizer.run over TrainStep.image(fused=True) at a tiny size: every
    loss finite, the last below the first, frame batches from the
    Optimizer's generator, and no kernel launched (CPU tensors take the
    plain versions)."""
    s = setup
    rng = np.random.default_rng(4)
    nt = 6
    t_frames = units.Quantity(np.linspace(0.0, 0.2, nt), 'hr')
    target = 1e-3 * rng.random((nt, 8, 8)).astype(np.float32)
    train_step = TrainStep.image(t_frames, target, s['pred'], fused=True,
                                 device='cpu')
    opt = Optimizer({'num_iters': 8, 'lr_init': 1e-3, 'seed': 0},
                    s['pred'], s['crt'], device='cpu')
    losses = []
    launches = (fused.render_fwd.launches, fused.render_bwd.launches)
    opt.run(3, train_step, s['crt'],
            log_fns=[LogFn(lambda o: losses.append(float(o.loss)))],
            verbose=False)
    assert len(losses) == 8 and opt.state.step == 8
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert (fused.render_fwd.launches, fused.render_bwd.launches) == launches



@pytest.mark.parametrize('entry_point', [
    Optimizer.__init__, TrainStep.image, TemporalBatchedArgs.__init__,
    step.raytracing_args, NeRFPredictor.init_params,
    NeRFPredictor.params_from_jax, alma.get_raytracing_args,
    emission.image_plane_dynamics, fields.init_mlp_params,
    visualization.VolumeVisualizer.__init__, visualization.ipyvolume_3d,
    t1.main, t2.main, t3.main, t4.main, t5.main, recovery_animation.main,
    selfcal_known_corruption.main],
    ids=lambda f: f.__qualname__ if f.__qualname__ != 'main'
    else f'{f.__module__.rsplit(".", 1)[-1]}.main')
def test_entry_points_default_to_the_card(entry_point):
    """The port's entry points run on the card unless the caller asks for
    the CPU (as these tests do): each one's `device` defaults to 'cuda'."""
    assert inspect.signature(entry_point).parameters['device'].default \
        == 'cuda'
