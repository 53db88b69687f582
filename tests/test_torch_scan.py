"""The chunked training loop of bhnerf_tpu_torch against the JAX package's
scan (tests/test_ensemble_scan.py, tests/test_training.py:253-480).

A chunk of the port (step.make_scan_step, make_composed_scan_step) is
held against the JAX package's lax.scan function on the same params, for
one loss, a composed image + lightcurve loss and a 3-variant ensemble:
the frame batches and variants the JAX scan draws inside from its key are
rebuilt with the same jax.random calls and handed to the port's chunk as
explicit indices. Loss series to rtol 2e-5 at every step; params after the
chunk to atol 1e-3 of the sum of the chunk's learning rates (the rule of
tests/test_torch_checkpoint.py). The rest holds the port's
Optimizer.run(scan_chunk=k) to its per-step loop and to the reference's
cadence, resume, SIGTERM, non-finite and ensemble rules.

The ray constants are seeded synthetic 8x8x16 tables (no geodesics), the
MLP 2x32, the movie 10 frames. Both packages run their fused paths on
the same compacted samples: the port's kernels take their plain versions
on the CPU and the JAX package's Pallas kernels run in interpret mode,
so both encode positions by the same double-angle recursion (the JAX
package's XLA path evaluates sin(2^k x) directly, 1e-6 apart in the loss,
which Adam's normalised updates amplify on gradients that change sign
from batch to batch).
"""
import dataclasses
import os
import shutil
import signal

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bhnerf_tpu import units as j_units
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.train import TrainState as JTrainState
from bhnerf_tpu.train import make_optimizer as j_make_optimizer
from bhnerf_tpu.train import step as j_step

import torch

from bhnerf_tpu_torch import units
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.ops import fused
from bhnerf_tpu_torch.train import state as state_lib
from bhnerf_tpu_torch.train import step
from bhnerf_tpu_torch.train.optimizer import LogFn, Optimizer, TrainStep
from bhnerf_tpu_torch.train.state import TrainState, make_optimizer

NT, BATCH, NUM_VARIANTS = 10, 4, 3
PRED_KW = dict(scale=8.0, rmax=8.0, z_width=2.0, net_depth=2, net_width=32)
PRED = NeRFPredictor(**PRED_KW)
JPRED = JPredictor(**PRED_KW)
SCALES = (1.0, 0.5)      # the composed step's 'full' and 'lc' scales


def _fields(seed):
    """Variant `seed` of the table: the wider its z range, the fewer of its
    samples lie in the emission shell (|z| < 2)."""
    rng = np.random.default_rng(seed)
    shape = (8, 8, 16)
    z_max = 2.5 + seed
    fields = dict(
        coords=np.stack([rng.uniform(-7, 7, shape), rng.uniform(-7, 7, shape),
                         rng.uniform(-z_max, z_max, shape)]),
        Omega=rng.uniform(0.02, 0.08, shape), g=rng.uniform(0.5, 1.5, shape),
        dtau=rng.uniform(0.5, 1.0, shape), Sigma=rng.uniform(0.5, 1.0, shape),
        t_geos_rel=rng.uniform(0.0, 50.0, shape))
    return {k: v.astype(np.float32) for k, v in fields.items()}


@pytest.fixture(scope='module')
def problem():
    """Three seeded variants of an 8x8x16 ray table with different
    in-domain counts, compacted to one shape ('gather'); the 'full' and
    'lc' steps on a 10-frame seeded movie."""
    fields = [_fields(seed) for seed in range(NUM_VARIANTS)]
    rts = [step.RayTracingArgs(
        **{k: torch.as_tensor(v) for k, v in f.items()}, J=1.0,
        t_injection=torch.zeros(()), t_to_M=100.0, t_units=units.hr)
        for f in fields]
    crts = step.compact_ensemble_args(rts, PRED, layout='gather')
    rng = np.random.default_rng(7)
    t_hr = np.linspace(0.0, 0.05, NT)
    target = (0.02 * rng.random((NT, 8, 8))).astype(np.float32)
    lc = target.sum(axis=(-1, -2))
    t_q = units.Quantity(t_hr, 'hr')
    full = TrainStep.image(t_q, target, PRED, fused=True, device='cpu')
    lc_step = TrainStep.image(t_q, lc, PRED, dtype='lc', scale=SCALES[1],
                              fused=True, device='cpu')
    return dict(fields=fields, crts=crts, t_hr=t_hr, target=target, lc=lc,
                full=full, lc_step=lc_step, composed=full + lc_step)


@pytest.fixture(scope='module')
def j_problem(problem):
    """The same variants for the JAX package: its own compaction (which
    must pick the port's samples and padding) with the port's compacted
    weights, summed in another order there."""
    rts = [j_step.RayTracingArgs(
        **{k: jnp.asarray(v) for k, v in f.items()}, J=1.0,
        t_injection=jnp.zeros((), jnp.float32), t_to_M=100.0,
        t_units=j_units.hr) for f in problem['fields']]
    crts = j_step.compact_ensemble_args(rts, JPRED, tile=fused.TILE_N,
                                        layout='gather')
    out = []
    for crt, port in zip(crts, problem['crts']):
        for field in ('coords', 't_geos_rel', 'pixel_ids', 'red_gather',
                      'red_group_ids'):
            np.testing.assert_array_equal(
                np.asarray(getattr(crt, field)),
                getattr(port, field).numpy().astype(
                    np.asarray(getattr(crt, field)).dtype))
        out.append(dataclasses.replace(
            crt, weights=jnp.asarray(port.weights.numpy()),
            red_weights=jnp.asarray(port.red_weights.numpy())))
    return out


def _frames(x, t_hr):
    """The JAX step's frame tensors (target, sigma, offset, t_frames)."""
    x = jnp.asarray(x)
    return (x, jnp.ones_like(x), jnp.zeros_like(x),
            jnp.asarray(t_hr, jnp.float32))


def _jax_chain(key, chunk, num_variants):
    """The frame batches and variants a JAX scan draws from `key`
    (step.py:1111-1119), rebuilt with the same calls."""
    indices, variants = [], []
    for k in jax.random.split(key, chunk):
        k_batch, k_var = jax.random.split(k)
        indices.append(np.asarray(jax.random.choice(k_batch, NT, (BATCH,),
                                                    replace=False)))
        variants.append(int(jax.random.randint(k_var, (), 0, num_variants))
                        if num_variants > 1 else 0)
    return np.stack(indices).astype(np.int64), variants


def _lifted_init():
    """JAX initial params with the head bias lifted so that the emission
    and its gradients are macroscopic."""
    init = jax.tree_util.tree_map(np.asarray, JPRED.init_params(seed=0))
    head = f'dense_{JPRED.net_depth}'
    init[head]['bias'] = init[head]['bias'] + 8.0
    return init


@pytest.mark.parametrize('case', ['single', 'composed', 'ensemble'])
def test_chunk_matches_jax_scan(problem, j_problem, case):
    """The port's chunk on the JAX scan's rebuilt draws: the same loss at
    every step (rtol 2e-5) and the same params after the chunk."""
    chunk = 6
    num_variants = NUM_VARIANTS if case == 'ensemble' else 1
    key = jax.random.PRNGKey(5)
    init = _lifted_init()
    j_rt = (j_step.stack_ensemble(j_problem) if case == 'ensemble'
            else j_problem[0])
    rt = problem['crts'] if case == 'ensemble' else problem['crts'][0]
    n_updates = chunk * (2 if case == 'composed' else 1)
    j_state = JTrainState.create(init, j_make_optimizer(20))
    state = TrainState.create(PRED.params_from_jax(init, device='cpu'),
                              make_optimizer(20))
    indices, variants = _jax_chain(key, chunk, num_variants)
    t_hr = problem['t_hr']
    if case == 'composed':
        meta = lambda dtype: tuple(sorted(dict(
            predictor=JPRED, kind='image', dtype=dtype, fused=True).items()))
        j_fn = j_step.make_composed_scan_step(
            batchsize=BATCH, chunk=chunk, metas=(meta('full'), meta('lc')),
            scales=SCALES)
        j_state, j_losses = j_fn(j_state, *_frames(problem['target'], t_hr),
                                 *_frames(problem['lc'], t_hr), key, j_rt)
        fn = step.make_composed_scan_step(
            batchsize=BATCH, chunk=chunk,
            metas=problem['composed'].scan_metas, scales=SCALES)
        frames = [t for a in problem['composed'].args for t in a.device_args]
        state, losses = fn(state, *frames, torch.as_tensor(indices),
                           variants, rt)
    else:
        j_fn = j_step.make_scan_step(predictor=JPRED, kind='image',
                                     dtype='full', fused=True,
                                     batchsize=BATCH, chunk=chunk,
                                     num_variants=num_variants)
        j_state, j_losses = j_fn(j_state, *_frames(problem['target'], t_hr),
                                 key, j_rt, 1.0)
        fn = step.make_scan_step(batchsize=BATCH, chunk=chunk,
                                 **problem['full'].scan_meta)
        state, losses = fn(state, *problem['full'].args[0].device_args,
                           torch.as_tensor(indices), variants, rt, 1.0)
    if case == 'ensemble':
        assert len(set(variants)) > 1, variants
    assert tuple(losses.shape) == (chunk,) and state.step == n_updates
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses),
                               rtol=2e-5)
    atol = 1e-3 * sum(state.tx.lr(k) for k in range(n_updates))
    j_params = jax.tree_util.tree_map(np.asarray, j_state.params)
    for i, layer in enumerate(state.params.mlp.layers):
        ref = j_params[f'dense_{i}']
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   ref['kernel'].T, rtol=0, atol=atol)
        np.testing.assert_allclose(layer.bias.detach().numpy(), ref['bias'],
                                   rtol=0, atol=atol)
        moved = np.abs(layer.bias.detach().numpy()
                       - init[f'dense_{i}']['bias']).max()
        assert moved > 10 * atol, f'layer {i} did not move'


def test_stack_ensemble(problem):
    """stack_ensemble puts a leading variant axis on every tensor field
    (as the JAX package's does), whose entry v is variant v, and keeps the
    static fields; one variant comes back as it is."""
    crts = problem['crts']
    stacked = step.stack_ensemble(crts)
    j_like = (len(crts), *crts[0].coords.shape)
    assert tuple(stacked.coords.shape) == j_like
    assert stacked.red_group_ids.shape[0] == len(crts)
    leaves = step.check_ensemble(crts)
    for v, crt in enumerate(crts):
        for f in dataclasses.fields(crt):
            a, b = getattr(stacked, f.name), getattr(crt, f.name)
            if f.name in leaves:
                assert torch.equal(a[v], b), f.name
            else:
                assert a is b or a == b, f.name
    assert step.stack_ensemble(crts[:1]) is crts[0]
    assert step.stack_ensemble(crts[0]) is crts[0]


@pytest.mark.parametrize('change', ['shape', 'static'])
def test_stack_ensemble_error_matches_jax(problem, j_problem, change):
    """Variants that differ in shape (compacted one by one, unpadded) or in
    a static field cannot be stacked: both packages raise ValueError with
    the same message."""
    port_rts = [step.RayTracingArgs(
        **{k: torch.as_tensor(v) for k, v in f.items()}, J=1.0,
        t_injection=torch.zeros(()), t_to_M=100.0, t_units=units.hr)
        for f in problem['fields'][:2]]
    j_rts = [j_step.RayTracingArgs(
        **{k: jnp.asarray(v) for k, v in f.items()}, J=1.0,
        t_injection=jnp.zeros((), jnp.float32), t_to_M=100.0,
        t_units=j_units.hr) for f in problem['fields'][:2]]
    if change == 'shape':
        port = [step.compact_raytracing_args(rt, PRED, layout='gather')
                for rt in port_rts]
        jx = [j_step.compact_raytracing_args(rt, JPRED, tile=fused.TILE_N,
                                             layout='gather')
              for rt in j_rts]
        assert port[0].coords.shape != port[1].coords.shape
    else:
        port = [problem['crts'][0],
                dataclasses.replace(problem['crts'][1], t_start_obs=1.0)]
        jx = [j_problem[0], dataclasses.replace(j_problem[1],
                                                t_start_obs=1.0)]
    message = 'ensemble variants are not uniformly shaped'
    with pytest.raises(ValueError, match=message):
        j_step.stack_ensemble(jx)
    with pytest.raises(ValueError, match=message):
        step.stack_ensemble(port)
    with pytest.raises(ValueError, match=message):
        step.check_ensemble(port)


def _optimizer(problem, num_iters=12, ckpt='', seed=3, **kw):
    return Optimizer({'num_iters': num_iters, 'lr_init': 1e-3,
                      'lr_final': 1e-5, 'seed': seed}, PRED,
                     problem['crts'], checkpoint_dir=str(ckpt) if ckpt
                     else '', device='cpu', **kw)


def _series(problem, train_step, rt, scan_chunk, num_iters=12):
    opt = _optimizer(problem, num_iters)
    seen = []
    opt.run(BATCH, train_step, rt,
            log_fns=[LogFn(lambda o: seen.append(
                (o.step, float(o.loss), o.variant)))],
            verbose=False, scan_chunk=scan_chunk)
    return seen, opt


@pytest.mark.parametrize('case', ['single', 'composed', 'ensemble'])
def test_chunked_run_equals_per_step_run(problem, case):
    """Optimizer.run(scan_chunk=5) and the per-step loop from the same
    seed: the same (step, loss, variant) at every step, bitwise, a ragged
    last chunk included, and the same params."""
    train_step = problem['composed' if case == 'composed' else 'full']
    rt = problem['crts'] if case == 'ensemble' else problem['crts'][0]
    per_step, opt0 = _series(problem, train_step, rt, 0)
    chunked, opt5 = _series(problem, train_step, rt, 5)
    assert [s for s, _, _ in chunked] == list(range(1, 13))
    assert chunked == per_step
    if case == 'ensemble':
        assert len({v for _, _, v in chunked}) > 1
    for a, b in zip(opt0.params.parameters(), opt5.params.parameters()):
        assert torch.equal(a, b)


def test_scan_metas_compose(problem):
    """TrainStep.image carries its chunk's keyword arguments; `+` keeps one
    per loss, and scan_meta is the single-loss surface only."""
    full, composed = problem['full'], problem['composed']
    assert full.scan_meta == dict(
        predictor=PRED, kind='image', dtype='full', fused=True, tv_scale=0.0,
        tv_fov=None, tv_resolution=32)
    assert len(composed.scan_metas) == 2 and composed.scan_meta is None
    assert [m['dtype'] for m in composed.scan_metas] == ['full', 'lc']
    bare = TrainStep(full.dtype, full.args, full.grad_fn, full.test_fn,
                     full.scale)
    assert bare.scan_metas is None and (bare + full).scan_metas is None


def test_unscannable_step_takes_the_per_step_loop(problem, monkeypatch):
    """A TrainStep without scan metas runs the per-step loop whatever
    scan_chunk says."""
    full = problem['full']
    bare = TrainStep(full.dtype, full.args, full.grad_fn, full.test_fn,
                     full.scale)
    calls = []
    monkeypatch.setattr(Optimizer, '_chunk',
                        lambda *a, **k: calls.append(k))
    seen, _ = _series(problem, bare, problem['crts'][0], 5)
    assert calls == [] and [s for s, _, _ in seen] == list(range(1, 13))


def test_chunk_checks_its_inputs(problem):
    """A chunk refuses indices or variants of the wrong count, and variant
    numbers past its ray constants."""
    fn = step.make_scan_step(batchsize=BATCH, chunk=3,
                             **problem['full'].scan_meta)
    state = TrainState.create(PRED.init_params(device='cpu'),
                              make_optimizer(10))
    frames = problem['full'].args[0].device_args
    idx = torch.zeros((3, BATCH), dtype=torch.int64)
    crt = problem['crts'][0]
    with pytest.raises(ValueError, match='indices of shape'):
        fn(state, *frames, idx[:2], [0, 0, 0], crt, 1.0)
    with pytest.raises(ValueError, match='2 variants'):
        fn(state, *frames, idx, [0, 0], crt, 1.0)
    with pytest.raises(ValueError, match='over 1 set'):
        fn(state, *frames, idx, [0, 1, 0], crt, 1.0)
    with pytest.raises(ValueError, match='over 2 set'):
        fn(state, *frames, idx, [0, 2, 0], problem['crts'][:2], 1.0)
    assert state.step == 0


def _checkpoints(path):
    return sorted(int(p.name.split('_')[1]) for p in path.iterdir()
                  if p.name.startswith('checkpoint_'))


def test_log_and_checkpoint_cadence(tmp_path, problem):
    """Chunks end at every log period (> 1) and save period, so a LogFn of
    period 6 fires at 6, 12, 18 and the checkpoints are the per-step
    loop's (8, 16 and the last step, 20), whatever the chunk size
    (test_training.py:347-370)."""
    listings, seen = {}, {}
    for scan_chunk in (0, 9):
        path = tmp_path / str(scan_chunk)
        opt = _optimizer(problem, 20, path, save_period=8, keep=0)
        seen[scan_chunk] = []
        opt.run(BATCH, problem['full'], problem['crts'][0],
                log_fns=[LogFn(lambda o: seen[scan_chunk].append(o.step),
                               log_period=6)],
                verbose=False, scan_chunk=scan_chunk)
        listings[scan_chunk] = _checkpoints(path)
    assert listings[9] == listings[0] == [8, 16, 20]
    assert seen[0] == [1, 6, 12, 18] and seen[9] == [6, 12, 18]


def test_per_step_logfn_replay(problem):
    """A log_period == 1 LogFn does not cut the chunks: it is replayed from
    each chunk's losses (the per-step loop's series), seeing end-of-chunk
    params, while a raw callable fires once per chunk
    (test_training.py:373-400)."""
    series, ends = [], []

    def per_step(o):
        series.append((o.step, float(o.loss),
                       float(o.params.mlp.layers[0].bias.detach().sum())))

    opt = _optimizer(problem, 25)
    opt.run(BATCH, problem['full'], problem['crts'][0],
            log_fns=[LogFn(per_step), lambda o: ends.append(o.step)],
            verbose=False, scan_chunk=10)
    assert [s for s, _, _ in series] == list(range(1, 26))
    assert ends == [10, 20, 25]
    per_step_run, _ = _series(problem, problem['full'], problem['crts'][0],
                              0, num_iters=25)
    assert [(s, l) for s, l, _ in series] == \
        [(s, l) for s, l, _ in per_step_run]
    for lo, hi in ((0, 10), (10, 20), (20, 25)):
        assert len({p for _, _, p in series[lo:hi]}) == 1


def test_resume_continues_the_step_count(tmp_path, problem):
    """A chunked run checkpoints its last step; a new Optimizer on the
    directory restores it and a chunked run goes on from there
    (test_training.py:403-423)."""
    opt = _optimizer(problem, 10, tmp_path)
    opt.run(BATCH, problem['full'], problem['crts'][0], verbose=False,
            scan_chunk=4)
    assert opt.state.step == 10 and _checkpoints(tmp_path) == [10]
    again = _optimizer(problem, 5, tmp_path)
    assert again.state.step == 10
    again.run(BATCH, problem['full'], problem['crts'][0], verbose=False,
              scan_chunk=4)
    assert again.init_step == 11 and again.state.step == 15
    assert np.isfinite(float(again.loss)) and _checkpoints(tmp_path) == \
        [10, 15]


@pytest.mark.parametrize('scan_chunk', [0, 3])
def test_resumed_run_draws_fresh_batches(tmp_path, problem, monkeypatch,
                                         scan_chunk):
    """A resumed run draws from a generator seeded by (seed, first step):
    its batches differ from the first run's, and the same resume draws
    the same batches twice; a fresh run draws from the generator that drew
    its weights, as before."""
    from bhnerf_tpu_torch.train.optimizer import TemporalBatchedArgs
    drawn = []
    sample = TemporalBatchedArgs.sample

    def spy(self, batchsize, generator=None):
        batch = sample(self, batchsize, generator)
        drawn[-1].append(batch.tolist())
        return batch

    monkeypatch.setattr(TemporalBatchedArgs, 'sample', spy)

    def run(path, num_iters=6):
        drawn.append([])
        opt = _optimizer(problem, num_iters, path)
        opt.run(BATCH, problem['full'], problem['crts'][0], verbose=False,
                scan_chunk=scan_chunk)
        return drawn[-1]

    first = run(tmp_path / 'a')
    gen = torch.Generator().manual_seed(3)
    PRED.init_params(generator=gen, device='cpu')
    assert first == [torch.randperm(NT, generator=gen)[:BATCH].tolist()
                     for _ in range(6)]
    shutil.copytree(tmp_path / 'a', tmp_path / 'b')
    resumed = run(tmp_path / 'a')
    again = run(tmp_path / 'b')
    assert resumed == again and resumed != first


def test_sigterm_stops_at_the_chunk(tmp_path, problem):
    """A SIGTERM during a chunked run stops it at the end of that chunk,
    with the step checkpointed (test_training.py:451-480)."""
    opt = _optimizer(problem, 12, tmp_path, save_period=1000)
    seen = []

    def preempt(o):
        seen.append(o.step)
        if o.step >= 6:
            os.kill(os.getpid(), signal.SIGTERM)

    opt.run(BATCH, problem['full'], problem['crts'][0],
            log_fns=[LogFn(preempt, log_period=3)], verbose=False,
            scan_chunk=3)
    assert seen == [3, 6] and opt.state.step == 6
    assert _checkpoints(tmp_path) == [6]
    restored = state_lib.restore_checkpoint(tmp_path, TrainState.create(
        PRED.init_params(device='cpu'), make_optimizer(10)))
    assert restored.step == 6
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_non_finite_loss_stops_after_the_chunk(problem):
    """A chunk whose last loss is not finite stops the run after that chunk
    with a warning."""
    bad = problem['target'].copy()
    bad[:] = np.nan
    train_step = TrainStep.image(units.Quantity(problem['t_hr'], 'hr'), bad,
                                 PRED, fused=True, device='cpu')
    opt = _optimizer(problem, 12)
    with pytest.warns(UserWarning, match='non-finite loss at step 4'):
        opt.run(BATCH, train_step, problem['crts'][0], verbose=False,
                scan_chunk=4)
    assert opt.state.step == 4


def test_unstackable_ensemble_warns_and_runs_per_step(problem):
    """An ensemble whose variants differ in shape warns and trains in the
    per-step loop (optimizer.py:155-167): the loss series of scan_chunk=0."""
    rts = [step.RayTracingArgs(
        **{k: torch.as_tensor(v) for k, v in f.items()}, J=1.0,
        t_injection=torch.zeros(()), t_to_M=100.0, t_units=units.hr)
        for f in problem['fields'][:2]]
    ragged = [step.compact_raytracing_args(rt, PRED, layout='gather')
              for rt in rts]
    with pytest.warns(UserWarning, match='ensemble not scannable'):
        chunked, _ = _series(problem, problem['full'], ragged, 4)
    per_step, _ = _series(problem, problem['full'], ragged, 0)
    assert chunked == per_step
