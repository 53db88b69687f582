"""Port parity of the multi-GPU support (bhnerf_tpu_torch.parallel)
against the JAX package's mesh code (tests/test_parallel.py), on the CPU.

The JAX side runs in this process on the conftest's virtual CPU devices,
under meshes of the same shapes as the port's. The port's side runs in
gloo processes (tests/_torch_parallel_worker.py), one a rank, started
once per job: 2 ranks here for meshes (1, 2) and (2, 1), 4 ranks for
(2, 2) in test_torch_parallel_ranks.py. Both sides take the same inputs,
made from a numpy seed: the JAX package's geodesic table at the
reference fixture's size (16x16 rays, ngeo 32, n_fine 2048, a 2x16 MLP)
and its float32 ray constants, which the port compacts itself, and the
JAX package's parameters (params_from_jax). On the CPU the port's fused
path runs the kernels' plain versions. Tolerances are the reference's
(tests/test_parallel.py:84-146): images rtol 2e-5, gradients rtol 2e-4,
each with an absolute floor of 1e-6 of the largest magnitude; chunked
losses rtol 2e-3 (:431-489).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from bhnerf_tpu import units as j_units
from bhnerf_tpu.geodesics import image_plane_geos as j_image_plane_geos
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.observation import dft_factors
from bhnerf_tpu.ops import gr as j_gr
from bhnerf_tpu.parallel import create_mesh as j_create_mesh
from bhnerf_tpu.train import TrainState as JTrainState
from bhnerf_tpu.train import TrainStep as JTrainStep
from bhnerf_tpu.train import make_optimizer as j_make_optimizer
from bhnerf_tpu.train import raytracing_args as j_raytracing_args
from bhnerf_tpu.train import step as j_step

import torch

from _torch_cores import cores_per_worker  # noqa: F401 (autouse)
import _torch_parallel_worker as worker
from bhnerf_tpu_torch.geodesics import trace_geodesics
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.parallel import mesh as mesh_lib
from bhnerf_tpu_torch.train import step

NT = 4
T_M = np.asarray([0.0, 50.0, 100.0, 150.0])
NPIX = 16
NVIS = 24
TRACE_KW = dict(spin=0.5, inclination=float(np.deg2rad(55)), ngeo=16,
                n_fine=1024)


def build_inputs(work):
    """The JAX package's tables and parameters, and the test's targets,
    written to <work>/inputs.npz for the ranks; returns the JAX side's
    objects."""
    geos = j_image_plane_geos(spin=0.0, inclination=np.deg2rad(60),
                              alpha_range=(-8, 8), beta_range=(-8, 8),
                              ngeo=32, num_alpha=NPIX, num_beta=NPIX,
                              n_fine=2048)
    Omega = geos.keplerian_omega()
    t_inj = -float(geos.r_o + 4)
    rt = j_raytracing_args(geos, Omega, t_inj, j_units.Quantity(0.0, 'hr'))
    umu = j_gr.azimuthal_velocity_vector(geos, Omega)
    g = j_gr.doppler_factor(geos, umu)
    b = j_gr.magnetic_field_fluid_frame(geos, umu, 0, 1, 0)
    J = np.nan_to_num(np.asarray(j_gr.parallel_transport(
        geos, umu, g, b, Q_frac=0.5, V_frac=0.0)), nan=0.0)
    rtp = j_raytracing_args(geos, Omega, t_inj, j_units.Quantity(0.0, 'hr'),
                            J=J)
    jpred = JPredictor(**worker.PRED_KW)
    params = jpred.init_params(seed=0)
    # lift the head so the emission (and its gradients) is macroscopic
    params['dense_2']['bias'] = params['dense_2']['bias'] + 8.0
    params = jax.tree_util.tree_map(np.asarray, params)

    rng = np.random.default_rng(0)
    t_hr = (T_M / rt.t_to_M).astype(np.float32)
    uv = rng.uniform(-2.0, 2.0, size=(2, NT, NVIS)) / 8e-10
    arrays = dict(
        coords=rt.coords, Omega=rt.Omega, g=rt.g, dtau=rt.dtau,
        Sigma=rt.Sigma, t_geos_rel=rt.t_geos_rel, J=rtp.J,
        t_start_obs=rt.t_start_obs, t_to_M=rt.t_to_M, t_hr=t_hr,
        target=rng.random((NT, NPIX, NPIX), np.float32),
        target_pol=rng.random((NT, 3, NPIX, NPIX), np.float32),
        lc_target=rng.random((NT, 3), np.float32) * 100,
        lc_sigma=np.asarray([1.0, 0.5, 0.5], np.float32),
        eht_target=rng.normal(size=(NT, NVIS)) + 1j * rng.normal(
            size=(NT, NVIS)),
        eht_sigma=np.ones((NT, NVIS)),
        eht_A_dense=np.exp(2j * np.pi * rng.random((NT, NVIS, NPIX ** 2)))
        / NPIX,
        eht_A_factored=np.stack([dft_factors(uv[0, f], uv[1, f], 8e-10,
                                             NPIX) for f in range(NT)]),
        eht_npix=NPIX,
        trace_alpha=rng.uniform(-8, 8, (11, 13)),
        trace_beta=rng.uniform(-8, 8, (11, 13)),
        trace_kw=json.dumps(TRACE_KW))
    arrays.update({f'p/{k}/{leaf}': v for k, d in params.items()
                   for leaf, v in d.items()})
    np.savez(os.path.join(work, 'inputs.npz'),
             **{k: np.asarray(v) for k, v in arrays.items()})
    return dict(rt=rt, rtp=rtp, jpred=jpred, params=params, t_hr=t_hr,
                arrays=arrays)


def jax_mesh(shape):
    return j_create_mesh(shape, devices=jax.devices()[:int(np.prod(shape))])


def jax_case(prob, case, shape):
    """The JAX package's images (all NT frames), loss and gradients of one
    case under a mesh of `shape`, from the same inputs as the ranks."""
    a = prob['arrays']
    mesh = jax_mesh(shape)
    pred, params = prob['jpred'], dict(prob['params'])
    if case == 'inject':
        pred = dataclasses.replace(pred, learn_injection=True)
        params['t_injection'] = np.float32(2.0)
    polarized = case in ('lc', 'native')
    crt = j_step.compact_raytracing_args(
        prob['rtp'] if polarized else prob['rt'], pred, tile=256, mesh=mesh,
        layout='native' if case == 'native' else 'gather')
    frames = NamedSharding(mesh, P('data'))
    put = lambda x: jax.device_put(jnp.asarray(x, jnp.float32), frames)
    t_M = put(crt.frame_times_M(prob['t_hr']))
    tv_scale = worker.TV_SCALE if case == 'tv' else 0.0
    if case.startswith('eht'):
        target, sigma, A = j_step.to_real_measurements(
            'vis', a['eht_target'], a['eht_sigma'], a[f'eht_A_{case[4:]}'])
        fn = lambda p: j_step.loss_fn_eht(p, pred, put(target), put(sigma),
                                          put(A), t_M, crt, 1.0, 'vis',
                                          fused=True)
    else:
        if case == 'lc':
            target = a['lc_target']
            sigma = np.broadcast_to(a['lc_sigma'], target.shape)
        else:
            target = a['target_pol'] if polarized else a['target']
            sigma = np.ones_like(target)
        fn = lambda p: j_step.loss_fn_image(
            p, pred, put(target), put(sigma), put(np.zeros_like(target)),
            t_M, crt, 1.0, 'lc' if case == 'lc' else 'full', fused=True)

    def loss(p):
        value, [images] = fn(p)
        if tv_scale:
            value = value + tv_scale * j_step.tv_loss(p, pred,
                                                      2 * pred.scale)
        return value, images

    (value, images), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    flat = {f'{k}/{leaf}': np.asarray(v) for k, d in grads.items()
            if isinstance(d, dict) for leaf, v in d.items()}
    if 't_injection' in grads:
        flat['t_injection'] = np.asarray(grads['t_injection'])
    return float(value), np.asarray(images), flat


def jax_chain(prob, shape, draws, init):
    """The JAX package's per-step TrainStep under a mesh of `shape` on the
    ranks' frame draws, from their initial parameters: the loss after
    every worker.CHUNK steps."""
    mesh = jax_mesh(shape)
    pred = prob['jpred']
    crt = j_step.compact_raytracing_args(prob['rt'], pred, tile=256,
                                         mesh=mesh)
    ts = JTrainStep.image(j_units.Quantity(prob['t_hr'], 'hr'),
                          prob['arrays']['target'], pred, dtype='full',
                          mesh=mesh if shape[0] > 1 else None)
    state = JTrainState.create(init, j_make_optimizer(
        num_iters=worker.CHUNK_STEPS, lr_init=1e-3))
    losses = []
    for i, inds in enumerate(draws):
        loss, state, _ = ts(state, crt, inds)
        if (i + 1) % worker.CHUNK == 0:
            losses.append(float(loss))
    return np.asarray(losses)


def close(out, ref, rtol):
    """out == ref to rtol, with an absolute floor of 1e-6 of ref's
    largest magnitude."""
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=1e-6 * np.abs(ref).max())


def unflatten(out, prefix):
    tree = {}
    for key in out.files:
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split('/')
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = np.asarray(out[key])
    return tree


class Job:
    """A compute job of `world` gloo ranks, started when the fixture is
    made and awaited when its outputs are first read."""

    def __init__(self, work, world, meshes, extra_env=None):
        self.work = work
        self.procs = worker.launch('compute', world, work, meshes,
                                   extra_env=extra_env)
        self.world = world
        self._outs = None

    @property
    def outs(self):
        if self._outs is None:
            worker.finish(self.procs)
            self._outs = [np.load(os.path.join(self.work, f'out_{r}.npz'))
                          for r in range(self.world)]
        return self._outs


def check_case(job, prob, case, shape):
    """Every rank's loss and gradients equal; rank 0's images, loss and
    gradients against the JAX package's under the same mesh shape."""
    name = 'x'.join(map(str, shape))
    key = f'{name}/{case}'
    value, images, grads = jax_case(prob, case, shape)
    outs = job.outs
    out = outs[0]
    for other in outs[1:]:
        assert float(other[f'{key}/loss']) == float(out[f'{key}/loss'])
        for k in grads:
            np.testing.assert_array_equal(other[f'{key}/grad/{k}'],
                                          out[f'{key}/grad/{k}'])
    np.testing.assert_allclose(float(out[f'{key}/loss']), value, rtol=2e-5)
    if case not in ('lc',) and not case.startswith('eht'):
        close(out[f'{key}/images'], images, 2e-5)
    for k, ref in grads.items():
        close(out[f'{key}/grad/{k}'], ref, 2e-4)
    if case == 'inject':
        assert float(out[f'{key}/grad/t_injection']) != 0.0


def check_census(job, shape, n_params, case='full'):
    """The collectives of the 'full' case: the forward one image-sized
    all-reduce over 'ray' (none without ray sharding); the gradient step
    that image all-reduce, one all-reduce of the n_params gradients over
    the axes that split the work and, with frames split, the loss over
    'data'; nothing larger. The 'lc' case (3 Stokes): the forward (a test
    step) sums the images and the lightcurve in one all-reduce; its
    gradient step sums the lightcurve alone, which is all its loss reads.
    Each rank renders its block only: local_n is about N/ray plus one
    tile."""
    name = 'x'.join(map(str, shape))
    data, ray = shape
    stokes = 3 if case == 'lc' else 1
    image = NT * stokes * NPIX * NPIX
    axes = '+'.join(a for a, n in zip(('data', 'ray'), shape) if n > 1)
    fwd, stp = {}, {}
    if ray > 1 and case == 'lc':
        fwd['image over ray'] = {'count': 1, 'largest': image + NT * stokes}
        stp['lightcurve over ray'] = {'count': 1,
                                      'largest': NT * stokes // data}
    elif ray > 1:
        fwd['image over ray'] = {'count': 1, 'largest': image}
        stp['image over ray'] = {'count': 1, 'largest': image // data}
    stp[f'grad over {axes}'] = {'count': 1, 'largest': n_params}
    if data > 1:
        stp['loss over data'] = {'count': 1, 'largest': 1}
    n_total = sum(int(o[f'{name}/{case}/n_valid']) for o in job.outs[:ray])
    for out in job.outs:
        assert json.loads(str(out[f'{name}/{case}/census_forward'])) == fwd
        assert json.loads(str(out[f'{name}/{case}/census_step'])) == stp
        local_n = int(out[f'{name}/{case}/local_n'])
        assert local_n <= n_total / ray + 256
        if ray > 1:
            assert local_n < n_total


def n_params(prob):
    return sum(np.size(v) for d in prob['params'].values()
               for v in d.values())


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp('ranks2')
    prob = build_inputs(work)
    job = Job(work, 2, '1x2,2x1')
    yield prob, job
    for p in job.procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize('shape', [(1, 2), (2, 1)], ids=str)
@pytest.mark.parametrize('case', ['full', 'tv', 'inject'])
def test_sharded_step_matches_jax(two_ranks, case, shape):
    """Images, loss and gradients of one gradient step under meshes (1, 2)
    (samples over 'ray', one image all-reduce) and (2, 1) (each rank's
    share of the 4-frame batch): every rank holds the same global loss and
    summed gradients, which match the JAX package's; with tv_scale > 0
    the total variation counts once; a learned t_injection's gradient is
    nonzero and matches (tests/test_parallel.py:84-146, 368-400)."""
    check_case(two_ranks[1], two_ranks[0], case, shape)


@pytest.mark.parametrize('case', ['lc', 'native', 'eht_dense',
                                  'eht_factored'])
def test_sharded_losses_match_jax(two_ranks, case):
    """Under mesh (1, 2): the ALMA 'lc' loss with 3-Stokes weights (image
    and lightcurve partials in one all-reduce), the polarized 'full' loss
    in the 'native' layout, and the EHT visibility loss with the dense
    and the factored operator (tests/test_parallel.py:149-190, 304-366,
    492-552)."""
    check_case(two_ranks[1], two_ranks[0], case, (1, 2))


@pytest.mark.parametrize('shape', [(1, 2), (2, 1)], ids=str)
def test_collective_census(two_ranks, shape):
    """Weak scaling: each rank's samples and the collectives it ran
    (tests/test_parallel.py:193-302)."""
    check_census(two_ranks[1], shape, n_params(two_ranks[0]))


def test_lc_census(two_ranks):
    """The ALMA 'lc' loss under (1, 2): a test step all-reduces the
    images and the lightcurve together, a gradient step the 3-Stokes
    lightcurve alone (12 floats, not the images' 3,072)."""
    check_census(two_ranks[1], (1, 2), n_params(two_ranks[0]), case='lc')


@pytest.mark.parametrize('shape', [(1, 2), (2, 1)], ids=str)
def test_chunked_training_matches_jax(two_ranks, shape):
    """Optimizer.run in chunks of 5 under the mesh: the ranks draw the
    same batches and report the same global losses, which track the JAX
    package's per-step TrainStep on those draws from the same initial
    parameters to rtol 2e-3 (tests/test_parallel.py:431-489)."""
    prob, job = two_ranks
    key = f'{shape[0]}x{shape[1]}/chunk'
    outs = job.outs
    for other in outs[1:]:
        np.testing.assert_array_equal(other[f'{key}/draws'],
                                      outs[0][f'{key}/draws'])
        np.testing.assert_array_equal(other[f'{key}/losses'],
                                      outs[0][f'{key}/losses'])
    draws = outs[0][f'{key}/draws']
    assert draws.shape == (worker.CHUNK_STEPS, worker.BATCH)
    ref = jax_chain(prob, shape, draws, unflatten(outs[0], f'{key}/init/'))
    losses = outs[0][f'{key}/losses']
    assert losses.shape == ref.shape == (worker.CHUNK_STEPS // worker.CHUNK,)
    np.testing.assert_allclose(losses, ref, rtol=2e-3)


def test_sharded_device_trace(two_ranks):
    """trace_geodesics(backend='device', mesh=) on the plain tracer: each
    rank traces its block of the 143 rays (padded to 144), the table is
    assembled on every rank, equal on both and to the one-process trace
    within the reference's 2e-6 (tests/test_parallel.py:555-573)."""
    prob, job = two_ranks
    a = prob['arrays']
    ref = trace_geodesics(a['trace_alpha'], a['trace_beta'],
                          backend='device', device='cpu', **TRACE_KW)
    for out in job.outs:
        for f in ('r', 'theta', 'phi', 't', 'tau_final', 'pm_r'):
            np.testing.assert_allclose(out[f'trace/{f}'],
                                       np.asarray(getattr(ref, f)),
                                       rtol=2e-6, atol=2e-6, err_msg=f)


def test_frames_api(two_ranks):
    """shard_frames and make_global_frames keep each rank's block of the
    frame axis (equal spans that add up to the frame count, an unequal one
    raises on every rank); replicate gives every rank rank 0's values
    (reference mesh.py:41-75, 187-208)."""
    outs = two_ranks[1].outs
    frames = np.arange(24, dtype=np.float32).reshape(-1, 3)
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out['api/shard'],
                                      frames[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(out['api/global'], out['api/shard'])
        assert 'differ across ranks' in str(out['api/unequal_error'])
        np.testing.assert_array_equal(out['api/replicated_w'], np.zeros(3))
        np.testing.assert_array_equal(out['api/replicated_a'], np.zeros(2))


@pytest.mark.parametrize('shards', [2, 4])
@pytest.mark.parametrize('layout', ['gather', 'native'])
def test_blocks_match_jax_layout(two_ranks, shards, layout):
    """compact_raytracing_args(mesh=) in each rank's place, no processes:
    the blocks concatenated equal the JAX package's sharded
    CompactRayArgs leaves bitwise, from the same float32 ray constants
    (tests/test_parallel.py:61-81, 109-146)."""
    prob = two_ranks[0]
    jpred, rt = prob['jpred'], prob['rtp'] if layout == 'native' \
        else prob['rt']
    ref = j_step.compact_raytracing_args(rt, jpred, tile=256,
                                         mesh=jax_mesh((1, shards)),
                                         layout=layout)
    assert ref.num_shards == shards
    pred = NeRFPredictor(**worker.PRED_KW)
    inp = {k: np.array(v) for k, v in prob['arrays'].items()}
    port = [step.compact_raytracing_args(
        worker.ray_constants(inp, layout == 'native'), pred, tile=256,
        mesh=mesh_lib.Mesh({'data': 1, 'ray': shards}, rank=r),
        layout=layout) for r in range(shards)]
    assert all(c.num_shards == shards for c in port)
    fields = ['coords', 'Omega', 'weights', 't_geos_rel', 'pixel_ids',
              'red_group_ids']
    if layout == 'gather':
        fields += ['red_gather', 'red_weights']
    for f in fields:
        got = np.concatenate([getattr(c, f).numpy() for c in port], axis=-1)
        want = np.asarray(getattr(ref, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=f)


def test_one_process_mesh_and_refusals(two_ranks):
    """Without a cluster: initialize_distributed() returns False
    (tests/test_parallel.py:625-627); create_mesh() is one rank on 'data'
    and its collectives are no-ops; create_hybrid_mesh reduces to it;
    create_mesh defaults to the card; shards > 1 without a mesh, a host
    trace with a mesh and a batch that the 'data' size does not divide
    raise ValueError (tests/test_parallel.py:555-573)."""
    env = {k: os.environ.pop(k) for k in ('RANK', 'WORLD_SIZE',
                                          'MASTER_ADDR', 'MASTER_PORT')
           if k in os.environ}
    try:
        assert mesh_lib.initialize_distributed() is False
    finally:
        os.environ.update(env)
    mesh = mesh_lib.create_mesh(device='cpu')
    assert mesh.shape == {'data': 1, 'ray': 1} and mesh.rank == 0
    x = torch.ones(3)
    mesh.all_reduce(x, ('data', 'ray'), 'grad')
    assert torch.equal(x, torch.ones(3)) and mesh.census.counts == {}
    hybrid = mesh_lib.create_hybrid_mesh(device='cpu')
    assert hybrid.shape == mesh.shape
    import inspect
    assert inspect.signature(mesh_lib.create_mesh).parameters[
        'device'].default == 'cuda'
    with pytest.raises(ValueError, match='#ranks'):
        mesh_lib.create_mesh((1, 2), device='cpu')
    two = mesh_lib.Mesh({'data': 2, 'ray': 1}, rank=1)
    assert list(mesh_lib.batch_share(np.arange(6), two)) == [3, 4, 5]
    with pytest.raises(ValueError, match='divide'):
        mesh_lib.batch_share(np.arange(5), two)
    a = np.array([[5.0]])
    with pytest.raises(ValueError, match='device'):
        trace_geodesics(a, a, 0.5, 1.0, backend='cpu', mesh=mesh)
    prob = two_ranks[0]
    rt = worker.ray_constants(
        {k: np.array(v) for k, v in prob['arrays'].items()}, False)
    with pytest.raises(ValueError, match='mesh'):
        step.compact_raytracing_args(rt, NeRFPredictor(**worker.PRED_KW),
                                     shards=2)


def test_hybrid_shape():
    """create_hybrid_mesh's shape (reference mesh.py:156-184, the node in
    the slice's place): the node axis folds into 'data', 'ray' stays
    inside a node (tests/test_parallel.py:576-622)."""
    assert mesh_lib.hybrid_shape(8, 4, (2, 2)) == (4, 2)
    assert mesh_lib.hybrid_shape(8, 4) == (8, 1)
    grid = np.arange(8).reshape(mesh_lib.hybrid_shape(8, 4, (2, 2)))
    for row in grid:           # every 'ray' row inside one node
        assert len({int(r) // 4 for r in row}) == 1
    assert {int(r) // 4 for r in grid[:, 0]} == {0, 1}
    with pytest.raises(ValueError, match='ranks/node'):
        mesh_lib.hybrid_shape(8, 4, (1, 2))
