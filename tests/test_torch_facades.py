"""The reference-API completeness of bhnerf_tpu_torch against bhnerf_tpu:
the kgeo, network and optimization facades (counterparts of
tests/test_facades.py), GridPredictor and its training (a counterpart of
tests/test_training.py::test_grid_predictor_trains),
NeRFPredictor.activation, the functional init_mlp_params / apply_mlp,
integrated_posenc / expected_sin, and optimization.shard.

Parameters cross with params_from_jax / params_to_numpy; inputs come from
numpy seeds. Tolerances (float32 on both sides): emissions and MLP
outputs atol 1e-6 (1e-5 for the MLP's raw output and for the fused
path's plain version, whose posenc is the double-angle recursion),
tv_reg and losses
rtol 1e-4, gradients 1e-4 normalised, integrated posenc atol 1e-6, the
metric rtol 1e-12 (float64 on both sides).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bhnerf_tpu import kgeo as j_kgeo
from bhnerf_tpu import network as j_network
from bhnerf_tpu import units as j_units
from bhnerf_tpu.models import fields as j_fields
from bhnerf_tpu.train import step as j_step

import torch
import torch.nn.functional as F

import bhnerf_tpu_torch
from bhnerf_tpu_torch import (constants, emission, kgeo, network,
                              optimization, units)
from bhnerf_tpu_torch.geodesics import image_plane_geos
from bhnerf_tpu_torch.models import fields
from bhnerf_tpu_torch.ops import fused
from bhnerf_tpu_torch.parallel import Mesh, create_mesh
from bhnerf_tpu_torch.train import (TrainState, TrainStep, make_optimizer,
                                    raytracing_args, save_checkpoint)
from _torch_cores import cores_per_worker  # noqa: F401 (autouse)

NERF_KW = dict(net_depth=2, net_width=16, scale=4.0, rmax=np.inf,
               z_width=np.inf)


def _pair(**kw):
    """The JAX package's predictor and params (seed 0) and the port's
    with the same params."""
    kw = dict(NERF_KW, **kw)
    j_kw = {k: v for k, v in kw.items() if k != 'activation'}
    jpred = j_fields.NeRFPredictor(**j_kw)
    jparams = jpred.init_params(seed=0)
    pred = fields.NeRFPredictor(**kw)
    params = pred.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  device='cpu')
    return jpred, jparams, pred, params


# ---------------------------------------------------------------------------
# counterparts of tests/test_facades.py
# ---------------------------------------------------------------------------
def test_tv_reg_finite_and_scales():
    """tv_reg is finite and positive, linear in lam, and the JAX package's
    value on the same params and points, in both coordinate layouts."""
    jpred, jparams, pred, params = _pair()
    coords = np.random.default_rng(0).uniform(-1, 1, (32, 3)).astype(
        np.float32)
    r1 = float(network.tv_reg(pred, params, coords, lam=1.0).detach())
    r2 = float(network.tv_reg(pred, params, coords, lam=2.0).detach())
    assert np.isfinite(r1) and r1 > 0
    np.testing.assert_allclose(r2, 2 * r1, rtol=1e-6)
    ref = float(j_network.tv_reg(jpred, jparams, coords, lam=1.0))
    np.testing.assert_allclose(r1, ref, rtol=1e-4)
    # the component-leading (3, ...) layout gives the same points
    r_lead = float(network.tv_reg(pred, params,
                                  coords.T.reshape(3, 4, 8)).detach())
    np.testing.assert_allclose(r_lead, r1, rtol=1e-6)
    # differentiable in the params, as a regularizer in a loss must be
    network.tv_reg(pred, params, coords).backward()
    assert params.mlp.layers[0].weight.grad.abs().sum() > 0


def test_flattened_traversal_mask():
    tree = {'a': {'t_injection': 1.0, 'w': 2.0}, 'b': {'w': 3.0}}
    fn = lambda path, _: path[-1] == 't_injection'
    mask = network.flattened_traversal(fn)(tree)
    assert mask == j_network.flattened_traversal(fn)(tree) == {
        'a': {'t_injection': True, 'w': False}, 'b': {'w': False}}
    # a module's parameters by their dotted names
    pred = fields.NeRFPredictor(**dict(NERF_KW, learn_injection=True))
    params = pred.init_params(device='cpu')
    module_mask = network.flattened_traversal(fn)(params)
    assert module_mask['t_injection'] is True
    assert module_mask['mlp']['layers']['0'] == {'weight': False,
                                                 'bias': False}


def test_lr_inject_masked_optimizer():
    """lr_inject gives t_injection its own Adam at that rate: Adam
    normalises, so |update| ~ lr for each group."""
    module = torch.nn.Module()
    module.t_injection = torch.nn.Parameter(torch.zeros(()))
    module.w = torch.nn.Parameter(torch.zeros(()))
    state = TrainState.create(module, make_optimizer(100, lr_init=1e-3,
                                                     lr_inject=1e-1))
    module.t_injection.grad = torch.ones(())
    module.w.grad = torch.ones(())
    state.apply_gradients()
    assert abs(float(module.t_injection)) > 10 * abs(float(module.w))
    np.testing.assert_allclose(-float(module.t_injection), 1e-1, rtol=1e-5)


def test_sample_checkpoint_3d(tmp_path):
    """The latest checkpoint's volume: the port's sample_3d_grid of the
    saved params, and the JAX package's volume of the same params."""
    jpred, jparams, pred, params = _pair()
    state = TrainState.create(params, make_optimizer(10))
    pred.save_params(tmp_path)
    save_checkpoint(tmp_path, state, 10)
    vol = network.sample_checkpoint_3d(tmp_path, fov=8.0, resolution=16,
                                       device='cpu')
    assert vol.shape == (16, 16, 16)
    ref = network.sample_3d_grid(pred, params, fov=8.0, resolution=16)
    np.testing.assert_allclose(vol, ref, atol=1e-6)
    j_ref = j_network.sample_3d_grid(jpred, jparams, fov=8.0, resolution=16)
    np.testing.assert_allclose(vol, np.asarray(j_ref), atol=1e-6)


def test_units_edge_cases():
    q = units.Quantity(2.0, 'hr')
    assert q.to('min').value == 120.0
    assert (3.0 * units.hr).unit == units.hr
    t = units.Quantity(np.array([1.0, 2.0]), 'hr')
    assert len(t) == 2 and t[1].value == 2.0
    assert (t + units.Quantity(30.0, 'min')).value[0] == 1.5
    with pytest.raises(ValueError):
        q.to('kg')
    assert units.Quantity(1.0, 'hr') / units.Quantity(30.0, 'min') == 2.0


# ---------------------------------------------------------------------------
# kgeo and the package's exports
# ---------------------------------------------------------------------------
def test_kgeo_facade_matches_jax():
    """The reference names are exported (the misspelt radiative_trasfer
    included), and the metric helpers give the JAX package's values on
    the same table."""
    for name in ('Geodesics', 'image_plane_geos', 'trace_geodesics',
                 'doppler_factor', 'parallel_transport', 'wave_vector',
                 'radiative_transfer', 'radiative_trasfer',
                 'equatorial_lensing', 'zamo_frame_tetrad'):
        assert hasattr(kgeo, name), name
    assert kgeo.radiative_trasfer is kgeo.radiative_transfer
    assert kgeo.equatorial_lensing.rho_of_req is not None
    rng = np.random.default_rng(3)
    geos = kgeo.Geodesics(**{
        f: rng.uniform(3.0, 10.0, (2, 3, 4)) for f in
        kgeo.Geodesics._FIELDS}, spin=0.5, inc=1.0)
    geos = dataclasses.replace(geos, theta=rng.uniform(0.2, 2.9, (2, 3, 4)))
    with jax.enable_x64(True):
        for fn in ('spacetime_metric', 'spacetime_inv_metric'):
            got, want = getattr(kgeo, fn)(geos), getattr(j_kgeo, fn)(geos)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                           rtol=1e-12, err_msg=k)
    b = kgeo.magnetic_field_spherical(geos, 1.0, 0.0, np.ones((2, 3, 4)))
    np.testing.assert_array_equal(
        b, j_kgeo.magnetic_field_spherical(geos, 1.0, 0.0,
                                           np.ones((2, 3, 4))))
    assert b.shape == (2, 3, 4, 3)


def test_package_exports_the_reference_names():
    for name in ('GRID_Predictor', 'GridPredictor', 'NeRF_Predictor',
                 'NeRFPredictor', 'apply_mlp', 'init_mlp_params', 'posenc',
                 'sample_3d_grid', 'kgeo', 'network', 'optimization'):
        assert hasattr(bhnerf_tpu_torch, name), name
    assert fields.GRID_Predictor is fields.GridPredictor
    assert fields.NeRF_Predictor is fields.NeRFPredictor
    for name in ('Optimizer', 'TrainStep', 'TemporalBatchedArgs', 'LogFn',
                 'total_movie_loss', 'SummaryWriter', 'StepTimer',
                 'profile_trace', 'shard'):
        assert hasattr(optimization, name), name


# ---------------------------------------------------------------------------
# GridPredictor
# ---------------------------------------------------------------------------
GRID_KW = dict(scale=4.0, rmin=1.0, rmax=5.0, z_width=2.0, grid_res=8)


def test_grid_emission_matches_jax():
    """The trilinear lookup with map_coordinates(order=1, cval=0)
    semantics: points beyond the grid (out-of-range corners count as 0),
    the domain fill and the validity mask, at atol 1e-6; and its volume
    through sample_3d_grid."""
    rng = np.random.default_rng(1)
    grid = rng.normal(0.0, 4.0, (8, 8, 8)).astype(np.float32) + 8.0
    jpred, pred = (j_fields.GridPredictor(**GRID_KW),
                   fields.GridPredictor(**GRID_KW))
    params = pred.params_from_jax({'grid': grid}, device='cpu')
    # up to 1.3x the grid's half-width: indices below 0 and above R - 1
    warped = rng.uniform(-5.2, 5.2, (6, 40, 3)).astype(np.float32)
    valid = rng.random((6, 40)) < 0.8
    coords = rng.uniform(-6, 6, (3, 40)).astype(np.float32)
    idx = (warped + 4.0) / 8.0 * 7.0
    assert (idx < 0).any() and (idx > 7).any()
    got = pred.emission_at(params, torch.as_tensor(warped),
                           torch.as_tensor(valid), torch.as_tensor(coords))
    want = jpred.emission_at({'grid': jnp.asarray(grid)}, warped, valid,
                             coords)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    vol = fields.sample_3d_grid(pred, params, fov=10.0, resolution=12)
    j_vol = j_fields.sample_3d_grid(jpred, {'grid': jnp.asarray(grid)},
                                    fov=10.0, resolution=12)
    np.testing.assert_allclose(vol, np.asarray(j_vol), atol=1e-6)
    np.testing.assert_array_equal(fields.params_to_numpy(params)['grid'],
                                  grid)


def test_grid_yaml_round_trip(tmp_path):
    """The reference's file name and keys: each package reads the other's
    file to the same predictor."""
    pred = fields.GridPredictor(**GRID_KW)
    pred.save_params(tmp_path / 'port')
    j_fields.GridPredictor(**GRID_KW).save_params(tmp_path / 'jax')
    assert (tmp_path / 'port' / 'GRID_Predictor_params.yml').exists()
    assert fields.GridPredictor.from_yml(tmp_path / 'port') == pred
    assert fields.GridPredictor.from_yml(tmp_path / 'jax') == pred
    assert j_fields.GridPredictor.from_yml(tmp_path / 'port') == \
        j_fields.GridPredictor(**GRID_KW)
    params = pred.init_params(device='cpu')
    assert params.grid.shape == (8, 8, 8) and (params.grid == -10.0).all()


FOV = 16.0


@pytest.fixture(scope='module')
def problem():
    """The reference's small recovery problem at 12x12 rays of 24 samples
    (n_fine 512): a hotspot's 16-frame movie over one orbit, rendered by
    the port on the host, and its ray constants."""
    geos = image_plane_geos(spin=0.0, inclination=np.deg2rad(60.0),
                            alpha_range=(-FOV / 2, FOV / 2),
                            beta_range=(-FOV / 2, FOV / 2), ngeo=24,
                            num_alpha=12, num_beta=12, n_fine=512)
    hotspot = emission.generate_hotspot(
        resolution=(32, 32, 32), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=6.5, std=0.7, r_isco=float(constants.isco_pro(0.0)),
        fov=FOV)
    Omega = float(1.0 / 6.5 ** 1.5)
    GM_hr = constants.GM_c3(constants.sgra_mass).to('hr').value
    t_frames = units.Quantity(
        np.linspace(0.0, 2 * np.pi / Omega * GM_hr, 16), 'hr')
    t_injection = -float(geos.r_o + FOV / 4)
    movie = emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection=t_injection,
        t_start_obs=t_frames[0], device='cpu').numpy()
    rt = raytracing_args(geos, Omega, t_injection, t_frames[0],
                         device='cpu')
    return dict(movie=movie, rt=rt, t_frames=t_frames)


def _jax_rt(rt):
    return j_step.RayTracingArgs(
        **{k: jnp.asarray(np.asarray(getattr(rt, k))) for k in
           ('coords', 'Omega', 'J', 'g', 'dtau', 'Sigma', 't_geos_rel')},
        t_injection=jnp.zeros((), jnp.float32), t_start_obs=rt.t_start_obs,
        t_to_M=rt.t_to_M, t_units=j_units.hr)


def test_grid_predictor_trains(problem):
    """The grid trains through the plain path (the reference starts it in
    the active sigmoid region at +10 for 150 Adam steps at lr 0.5 on a
    fixed batch): the loss falls tenfold. Its first step's loss and grid
    gradient are the JAX package's on the same ray constants (loss rtol
    1e-4, gradient 1e-4 normalised)."""
    pred = fields.GridPredictor(scale=FOV / 2, rmax=FOV / 2, z_width=2.0,
                                grid_res=16)
    params = pred.params_from_jax({'grid': np.full((16,) * 3, 10.0,
                                                   np.float32)},
                                  device='cpu')
    state = TrainState.create(params, make_optimizer(150, lr_init=0.5))
    train_step = TrainStep.image(problem['t_frames'], problem['movie'],
                                 pred, dtype='full', device='cpu')
    inds = np.arange(4)
    # the same step of the JAX package on the same constants
    jpred = j_fields.GridPredictor(scale=FOV / 2, rmax=FOV / 2, z_width=2.0,
                                   grid_res=16)
    rt = problem['rt']
    t_M = rt.frame_times_M(np.asarray(problem['t_frames'].value[inds],
                                      np.float32))
    target = problem['movie'][inds]
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: j_step.loss_fn_image(
            p, jpred, jnp.asarray(target), jnp.ones_like(target), 0.0,
            jnp.asarray(np.asarray(t_M)), _jax_rt(rt), 1.0, 'full'),
        has_aux=True)({'grid': jnp.full((16,) * 3, 10.0, jnp.float32)})
    losses = []
    for i in range(150):
        loss, state, _ = train_step(state, rt, inds)
        if i == 0:
            np.testing.assert_allclose(float(loss), float(j_loss),
                                       rtol=1e-4)
        losses.append(float(loss))
    assert np.mean(losses[-5:]) < 0.1 * np.mean(losses[:5]), (
        np.mean(losses[:5]), np.mean(losses[-5:]))
    # the gradient of the first step, recomputed from the start
    params0 = pred.params_from_jax({'grid': np.full((16,) * 3, 10.0,
                                                    np.float32)},
                                   device='cpu')
    from bhnerf_tpu_torch.train import step as step_lib
    loss0, _ = step_lib.loss_fn_image(
        params0, pred, torch.as_tensor(target), torch.ones(target.shape),
        torch.zeros(target.shape), torch.as_tensor(np.asarray(t_M)), rt,
        1.0, 'full')
    loss0.backward()
    want = np.asarray(j_grads['grid'])
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(params0.grid.grad.numpy() / scale,
                               want / scale, atol=1e-4, rtol=0)


def test_grid_predictor_on_the_fused_path_raises():
    """The fused kernels render a NeRF MLP: like the reference's fused
    switch (getattr(predictor, 'out_channel', 1) == 1), a grid with
    fused=True reaches them, and they refuse it."""
    pred = fields.GridPredictor(**GRID_KW)
    params = pred.init_params(device='cpu')
    coords = torch.zeros(3, 8)
    with pytest.raises(TypeError, match='fused=False'):
        fused.render_samples(params, pred, torch.zeros(2), coords,
                             torch.zeros(8), torch.zeros(8), -1.0)


# ---------------------------------------------------------------------------
# the NeRF MLP: activation, the functional API, integrated posenc
# ---------------------------------------------------------------------------
def test_activation_on_the_plain_path_matches_jax():
    """activation=softplus changes the plain path's emission, as the JAX
    package's activation=jax.nn.softplus does (atol 1e-6)."""
    jpred, jparams, pred, params = _pair(activation=F.softplus)
    jpred = dataclasses.replace(jpred, activation=jax.nn.softplus)
    rng = np.random.default_rng(2)
    warped = rng.uniform(-3, 3, (4, 30, 3)).astype(np.float32)
    valid = np.ones((4, 30), bool)
    coords = rng.uniform(-3, 3, (3, 30)).astype(np.float32)
    jparams['dense_2']['bias'] = jparams['dense_2']['bias'] + 8.0
    params.mlp.layers[2].bias.data += 8.0
    got = pred.emission_at(params, torch.as_tensor(warped),
                           torch.as_tensor(valid), torch.as_tensor(coords))
    want = jpred.emission_at(jparams, warped, valid, coords)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    relu = dataclasses.replace(pred, activation=torch.relu)
    assert not torch.allclose(
        relu.emission_at(params, torch.as_tensor(warped),
                         torch.as_tensor(valid), torch.as_tensor(coords)),
        got, atol=1e-4)


def test_activation_is_ignored_by_the_fused_path():
    """The fused kernels are ReLU-only (so are the reference's): their
    plain version gives a softplus predictor the ReLU emission."""
    _, _, pred, params = _pair(activation=F.softplus)
    params.mlp.layers[2].bias.data += 8.0
    relu = dataclasses.replace(pred, activation=torch.relu)
    rng = np.random.default_rng(4)
    coords = torch.as_tensor(rng.uniform(-3, 3, (3, 128)), dtype=torch.float32)
    omega = torch.as_tensor(rng.uniform(0.01, 0.1, 128), dtype=torch.float32)
    tg = torch.as_tensor(rng.uniform(-5, 0, 128), dtype=torch.float32)
    t_M = torch.tensor([3.0, 7.0])
    args = (t_M, coords, omega, tg, -20.0)
    em = fused.render_samples(params, pred, *args)
    np.testing.assert_array_equal(em.detach().numpy(), fused.render_samples(
        params, relu, *args).detach().numpy())
    warped, valid = emission.velocity_warp_coords(
        coords, omega, t_M, 0.0, tg, -20.0, return_mask=True)
    plain_relu = relu.emission_at(params, warped, valid, coords)
    # the kernels' posenc runs the double-angle recursion: 1e-5
    np.testing.assert_allclose(em.detach().numpy(),
                               plain_relu.detach().numpy(), atol=1e-5,
                               rtol=0)


def test_functional_mlp_matches_jax():
    """init_mlp_params: the reference's layout and shapes, he-uniform
    bounds, zero biases; apply_mlp on the JAX package's params equals its
    apply_mlp (atol 1e-5) and the port's MLP module on the same params."""
    in_dim = fields.posenc_feature_dim(3, 3)
    jparams = j_fields.init_mlp_params(jax.random.PRNGKey(3), in_dim,
                                       net_depth=4, net_width=32)
    params = fields.init_mlp_params(torch.Generator().manual_seed(3),
                                    in_dim, net_depth=4, net_width=32,
                                    device='cpu')
    assert params.keys() == jparams.keys()
    for k in params:
        for leaf in ('kernel', 'bias'):
            assert tuple(params[k][leaf].shape) == jparams[k][leaf].shape
        bound = np.sqrt(6.0 / params[k]['kernel'].shape[0])
        assert params[k]['kernel'].abs().max() <= bound
        assert params[k]['kernel'].std() > 0.4 * bound
        assert (params[k]['bias'] == 0).all()
    copied = {k: {leaf: torch.as_tensor(np.asarray(v))
                  for leaf, v in layer.items()} for k, layer in
              jparams.items()}
    x = np.random.default_rng(0).normal(size=(10, in_dim)).astype(
        np.float32)
    got = fields.apply_mlp(copied, torch.as_tensor(x), net_depth=4)
    want = j_fields.apply_mlp(jparams, x, net_depth=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    pred = fields.NeRFPredictor(net_depth=4, net_width=32)
    module = pred.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  device='cpu')
    np.testing.assert_allclose(
        module.mlp(torch.as_tensor(x)).detach().numpy(), got.numpy(),
        atol=1e-6)
    soft = fields.apply_mlp(copied, torch.as_tensor(x), net_depth=4,
                            activation=F.softplus)
    np.testing.assert_allclose(
        soft.numpy(), np.asarray(j_fields.apply_mlp(
            jparams, x, net_depth=4, activation=jax.nn.softplus)),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize('x_cov,min_deg', [(2e-5, 0), ('array', 1)])
def test_integrated_posenc_matches_jax(x_cov, min_deg):
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (7, 3)).astype(np.float32)
    if x_cov == 'array':
        x_cov = rng.uniform(0, 0.05, (7, 3)).astype(np.float32)
    got = fields.integrated_posenc(torch.as_tensor(x), x_cov, 4, min_deg)
    want = j_fields.integrated_posenc(jnp.asarray(x), x_cov, 4, min_deg)
    assert got.shape == want.shape == (7, 6 * (4 - min_deg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    var = rng.uniform(0, 1, (7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        fields.expected_sin(torch.as_tensor(x), torch.as_tensor(var)).numpy(),
        np.asarray(j_fields.expected_sin(x, var)), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# optimization.shard
# ---------------------------------------------------------------------------
def test_shard_without_a_mesh():
    """Leading axes become (device count, -1): one without a card; arrays,
    tensors and their nests alike. With a mesh, shard gives this rank's
    block of the leading axis by its 'data' coordinate (the whole axis
    for one process)."""
    n = max(torch.cuda.device_count(), 1)
    xs = {'a': np.arange(24).reshape(6, 4),
          'b': [torch.arange(12.0).reshape(6, 2)]}
    out = optimization.shard(xs)
    assert out['a'].shape == (n, 6 // n, 4)
    assert isinstance(out['b'][0], torch.Tensor)
    assert tuple(out['b'][0].shape) == (n, 6 // n, 2)
    np.testing.assert_array_equal(out['a'].reshape(6, 4), xs['a'])
    whole = optimization.shard(xs, mesh=create_mesh(device='cpu'))
    np.testing.assert_array_equal(whole['a'], xs['a'])
    half = optimization.shard(xs, mesh=Mesh({'data': 2, 'ray': 1}, rank=1))
    np.testing.assert_array_equal(half['a'], xs['a'][3:])
    assert torch.equal(half['b'][0], xs['b'][0][3:])
