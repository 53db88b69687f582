"""Checkpoints of bhnerf_tpu_torch: the `checkpoint_<step>` layout written
with torch.save, keep pruning, restore, the Optimizer's save period and
resume, and the SIGTERM checkpoint-and-return of its training loop
(counterparts of tests/test_training.py:178 and :426 and
tests/test_workflow_coverage.py:107), each also run through the
reference's Optimizer (bhnerf_tpu, orbax checkpoints) on the same
problem: the same checkpoint listings, the same stopping step, the same
step after a resume and the same parameters.

The ray constants are a small seeded synthetic table (4x4 rays x 16
samples inside the emission shell), so these tests need no geodesics;
the fit runs the fused path, whose kernels take their plain versions on
the CPU, and the reference its XLA path on the same compacted samples.
"""
import dataclasses
import os
import re
import shutil
import signal
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bhnerf_tpu import units as j_units
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.train import LogFn as JLogFn
from bhnerf_tpu.train import Optimizer as JOptimizer
from bhnerf_tpu.train import TrainState as JTrainState
from bhnerf_tpu.train import TrainStep as JTrainStep
from bhnerf_tpu.train import step as j_step

import torch

from bhnerf_tpu_torch import units
from bhnerf_tpu_torch.ops import fused
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.train import optimizer as optimizer_lib
from bhnerf_tpu_torch.train import state as state_lib
from bhnerf_tpu_torch.train import step
from bhnerf_tpu_torch.train.optimizer import LogFn, Optimizer, TrainStep
from bhnerf_tpu_torch.train.state import TrainState, make_optimizer

NT = 4
PRED_KW = dict(scale=8.0, rmax=8.0, z_width=2.0, net_depth=2, net_width=16)
PRED = NeRFPredictor(**PRED_KW)
JPRED = JPredictor(**PRED_KW)
CKPT_RE = re.compile(r'^checkpoint_\d+$')


@pytest.fixture(scope='module')
def problem():
    rng = np.random.default_rng(0)
    shape = (4, 4, 16)
    fields = dict(
        coords=np.stack([rng.uniform(-6, 6, shape),
                         rng.uniform(-6, 6, shape),
                         rng.uniform(-1.5, 1.5, shape)]),
        Omega=rng.uniform(0.02, 0.08, shape), g=rng.uniform(0.5, 1.5, shape),
        dtau=rng.uniform(0.5, 1.0, shape), Sigma=rng.uniform(0.5, 1.0, shape),
        t_geos_rel=rng.uniform(0.0, 50.0, shape))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    rt = step.RayTracingArgs(
        **{k: torch.as_tensor(v) for k, v in fields.items()}, J=1.0,
        t_injection=torch.zeros(()), t_to_M=100.0, t_units=units.hr)
    crt = step.compact_raytracing_args(rt, PRED, layout='gather')
    t_hr = np.linspace(0.0, 0.05, NT)
    target = (0.02 * rng.random((NT, 4, 4))).astype(np.float32)
    train_step = TrainStep.image(units.Quantity(t_hr, 'hr'), target, PRED,
                                 fused=True, device='cpu')
    return dict(crt=crt, train_step=train_step, fields=fields, t_hr=t_hr,
                target=target)


def make(problem, ckpt='', num_iters=8, lr_final=1e-5, **kw):
    return Optimizer({'num_iters': num_iters, 'lr_init': 1e-3,
                      'lr_final': lr_final, 'seed': 0}, PRED, problem['crt'],
                     checkpoint_dir=str(ckpt) if ckpt else '', device='cpu',
                     **kw)


def run(opt, problem, log_fns=()):
    opt.run(NT, problem['train_step'], problem['crt'], log_fns=log_fns,
            verbose=False)


def assert_states_equal(a, b):
    """Params, Adam state and step bitwise equal."""
    assert a.step == b.step
    for (na, pa), (nb, pb) in zip(a.params.state_dict().items(),
                                  b.params.state_dict().items()):
        assert na == nb and torch.equal(pa, pb), na
    sa, sb = a.opt.state_dict()['state'], b.opt.state_dict()['state']
    assert sa.keys() == sb.keys() and len(sa) > 0
    for k in sa:
        for key in ('step', 'exp_avg', 'exp_avg_sq'):
            assert torch.equal(sa[k][key], sb[k][key]), (k, key)


def checkpoint_dirs(path):
    return sorted(p.name for p in path.iterdir()
                  if p.name.startswith('checkpoint_'))


def test_checkpoint_roundtrip(tmp_path, problem):
    """A state after two updates, saved and restored into a fresh state
    with other weights: params, Adam state and step bitwise; the file
    loads under torch.load(weights_only=True); the predictor's yaml round
    trip (test_training.py:178)."""
    state = TrainState.create(
        PRED.init_params(generator=torch.Generator().manual_seed(0),
                         device='cpu'), make_optimizer(10))
    grad_fn, _ = step.make_step_fns(PRED, fused=True)
    args = problem['train_step'].args[0].device_args
    for _ in range(2):
        grad_fn(state, *args, torch.arange(NT), problem['crt'], 1.0)
    state_lib.save_checkpoint(tmp_path, state, 2)
    assert checkpoint_dirs(tmp_path) == ['checkpoint_2']
    payload = torch.load(tmp_path / 'checkpoint_2' / 'state.pt',
                         weights_only=True)
    assert set(payload) == {'step', 'params', 'opt_state'}
    fresh = TrainState.create(
        PRED.init_params(generator=torch.Generator().manual_seed(9),
                         device='cpu'), make_optimizer(10))
    restored = state_lib.restore_checkpoint(tmp_path, fresh)
    assert restored is fresh and restored.step == 2
    assert_states_equal(restored, state)
    PRED.save_params(tmp_path)
    assert NeRFPredictor.from_yml(tmp_path) == PRED


@pytest.mark.parametrize('keep,left', [(2, [4, 5]), (1, [5]),
                                       (0, [1, 2, 3, 4, 5]),
                                       (-1, [1, 2, 3, 4, 5])])
def test_keep_prunes_oldest(tmp_path, keep, left):
    """save_checkpoint keeps the newest `keep` checkpoints; keep <= 0
    keeps all (reference state.py:142-151); latest_checkpoint_step reads
    the largest step."""
    state = TrainState.create(PRED.init_params(device='cpu'),
                              make_optimizer(10))
    for s in range(1, 6):
        state.step = s
        state_lib.save_checkpoint(tmp_path, state, s, keep=keep)
    assert checkpoint_dirs(tmp_path) == sorted(f'checkpoint_{s}'
                                               for s in left)
    assert state_lib.latest_checkpoint_step(tmp_path) == 5


def test_restore_without_checkpoint(tmp_path):
    """restore_checkpoint is a no-op where no checkpoint exists (a missing
    or an empty directory); restore_params raises FileNotFoundError there,
    and otherwise returns the params as a state_dict or loaded into a
    given module."""
    state = TrainState.create(PRED.init_params(device='cpu'),
                              make_optimizer(10))
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    for path in (tmp_path / 'missing', tmp_path):
        assert state_lib.latest_checkpoint_step(path) is None
        assert state_lib.restore_checkpoint(path, state) is state
        assert state.step == 0
        with pytest.raises(FileNotFoundError):
            state_lib.restore_params(path)
    for k, v in state.params.state_dict().items():
        assert torch.equal(v, before[k])
    state.step = 3
    state_lib.save_checkpoint(tmp_path, state, 3)
    params = state_lib.restore_params(tmp_path)
    assert params.keys() == before.keys()
    assert all(torch.equal(params[k], before[k]) for k in before)
    other = PRED.init_params(generator=torch.Generator().manual_seed(5),
                             device='cpu')
    assert state_lib.restore_params(tmp_path, other) is other
    assert all(torch.equal(other.state_dict()[k], before[k]) for k in before)


def test_optimizer_checkpoint_resume(tmp_path, problem):
    """An Optimizer with a checkpoint_dir saves every save_period steps and
    at its last step, writes the predictor's yaml, and a new Optimizer on
    that directory resumes from the latest checkpoint: its step count
    continues and so do its params and Adam state
    (test_workflow_coverage.py:107)."""
    opt1 = make(problem, tmp_path, num_iters=7, save_period=3)
    run(opt1, problem)
    assert opt1.state.step == 7
    assert checkpoint_dirs(tmp_path) == ['checkpoint_3', 'checkpoint_6',
                                         'checkpoint_7']
    assert (tmp_path / 'NeRF_Predictor_params.yml').exists()
    assert opt1.params is opt1.state.params

    opt2 = make(problem, tmp_path, num_iters=5, save_period=3)
    assert_states_equal(opt2.state, opt1.state)
    run(opt2, problem)
    assert opt2.state.step == 12 and np.isfinite(float(opt2.loss))
    assert state_lib.latest_checkpoint_step(tmp_path) == 12


def test_sigterm_checkpoints_and_returns(tmp_path, problem):
    """A SIGTERM during the loop (sent from a LogFn mid-run) checkpoints
    the step it arrived in and returns cleanly; the SIGTERM handler the
    run found is back in place afterwards (test_training.py:426)."""
    prev = signal.getsignal(signal.SIGTERM)
    opt = make(problem, tmp_path, num_iters=20, save_period=1000)
    seen = []

    def preempt(o):
        seen.append(o.step)
        if o.step == o.init_step + 4:
            os.kill(os.getpid(), signal.SIGTERM)

    run(opt, problem, [LogFn(preempt)])
    assert seen[-1] == opt.init_step + 4 == 5, 'did not stop early'
    assert opt.state.step == 5
    assert checkpoint_dirs(tmp_path) == ['checkpoint_5']
    restored = state_lib.restore_checkpoint(tmp_path, TrainState.create(
        PRED.init_params(device='cpu'), make_optimizer(20)))
    assert_states_equal(restored, opt.state)
    assert signal.getsignal(signal.SIGTERM) == prev


def test_resume_after_sigterm_continues_the_schedule(tmp_path, problem):
    """A run preempted by SIGTERM at step 4 and resumed by a new Optimizer
    with the same hparams continues the learning-rate schedule from the
    restored step: its updates 5..8 use the uninterrupted run's learning
    rates exactly, and with a batch of every frame (so the draws do not
    matter) it reaches the uninterrupted run's params after step 8 (rtol
    1e-5, atol 1e-7: the frames are summed in another order)."""
    lrs = {}

    def record(name):
        def fn(o):
            lrs.setdefault(name, []).append(
                o.state.opt.param_groups[0]['lr'])
            if name == 'resumed' and o.step == 8:
                lrs['params_8'] = {k: v.clone() for k, v in
                                   o.params.state_dict().items()}
            if name == 'first' and o.step == 4:
                os.kill(os.getpid(), signal.SIGTERM)
        return LogFn(fn)

    whole = make(problem, num_iters=8, lr_final=1e-4)
    run(whole, problem, [record('whole')])
    first = make(problem, tmp_path, num_iters=8, lr_final=1e-4)
    run(first, problem, [record('first')])
    assert first.state.step == 4
    resumed = make(problem, tmp_path, num_iters=8, lr_final=1e-4)
    assert resumed.state.step == 4
    run(resumed, problem, [record('resumed')])
    assert resumed.state.step == 12
    tx = whole.state.tx
    assert lrs['whole'] == [tx.lr(k) for k in range(8)]
    assert lrs['first'] + lrs['resumed'][:4] == lrs['whole']
    assert lrs['resumed'][4:] == [tx.lr(8)] * 4
    init = PRED.init_params(generator=torch.Generator().manual_seed(0),
                            device='cpu').state_dict()
    for k, v in whole.params.state_dict().items():
        assert not torch.equal(v, init[k]), f'{k} did not move'
        np.testing.assert_allclose(lrs['params_8'][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_keyboard_interrupt_returns(tmp_path, problem):
    """A KeyboardInterrupt inside the loop ends run() without raising and
    without a checkpoint (reference optimizer.py:199-200)."""
    opt = make(problem, tmp_path, num_iters=10, save_period=1000)

    def interrupt(o):
        if o.step == 3:
            raise KeyboardInterrupt

    run(opt, problem, [LogFn(interrupt)])
    assert opt.state.step == 3
    assert checkpoint_dirs(tmp_path) == []


def test_graceful_shutdown_off_the_main_thread():
    """Off the main thread no handler can be installed: the scope is a
    no-op there and leaves the SIGTERM handler alone."""
    prev = signal.getsignal(signal.SIGTERM)
    out = {}

    def body():
        with optimizer_lib._GracefulShutdown() as shutdown:
            out['registered'] = shutdown._registered
            out['requested'] = shutdown.requested

    thread = threading.Thread(target=body)
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert out == {'registered': False, 'requested': False}
    assert signal.getsignal(signal.SIGTERM) == prev


def test_graceful_shutdown_restores_none_as_default(monkeypatch):
    """A previous handler installed outside Python reads as None and
    cannot be put back: the scope restores SIG_DFL instead, so a later
    SIGTERM still ends the process."""
    prev = signal.getsignal(signal.SIGTERM)
    calls = []
    real = signal.signal

    def fake(signum, handler):
        calls.append(handler)
        real(signum, handler)
        return None if len(calls) == 1 else prev

    monkeypatch.setattr(optimizer_lib.signal, 'signal', fake)
    try:
        with optimizer_lib._GracefulShutdown() as shutdown:
            assert shutdown._registered and shutdown._prev is None
        assert calls[-1] is signal.SIG_DFL
    finally:
        real(signal.SIGTERM, prev)


# ---------------------------------------------------------------------------
# against the reference Optimizer
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def j_problem(problem):
    """The problem for the reference: its ray constants from the same
    seeded fields, compacted in the 'gather' layout, with the port's
    compacted weights (the Doppler-free product g * dtau * Sigma, summed
    in another order there), and its image TrainStep on the same target
    and frame times."""
    rt = j_step.RayTracingArgs(
        **{k: jnp.asarray(v) for k, v in problem['fields'].items()}, J=1.0,
        t_injection=jnp.zeros((), jnp.float32), t_to_M=100.0,
        t_units=j_units.hr)
    crt = j_step.compact_raytracing_args(rt, JPRED, tile=fused.TILE_N,
                                         layout='gather')
    for field in ('coords', 't_geos_rel', 'pixel_ids', 'red_gather'):
        np.testing.assert_array_equal(
            np.asarray(getattr(crt, field)),
            getattr(problem['crt'], field).numpy().astype(
                np.asarray(getattr(crt, field)).dtype))
    crt = dataclasses.replace(
        crt, weights=jnp.asarray(problem['crt'].weights.numpy()),
        red_weights=jnp.asarray(problem['crt'].red_weights.numpy()))
    train_step = JTrainStep.image(j_units.Quantity(problem['t_hr'], 'hr'),
                                  problem['target'], JPRED, dtype='full')
    return dict(crt=crt, train_step=train_step)


HPARAMS = {'lr_init': 1e-3, 'lr_final': 1e-5, 'seed': 0}


def run_both(problem, j_problem, path, num_iters, save_period=-1, keep=5,
             sigterm_at=None):
    """One Optimizer of each package on the problem with the same
    hyper-parameters, checkpoint directory `path`/{jax,torch}, a batch of
    every frame (so the frame draws do not matter) and a LogFn that
    records each step and sends SIGTERM at step `sigterm_at`. A fresh
    port Optimizer starts from the reference's initial params. Returns
    (reference optimizer, port optimizer, {package: steps seen})."""
    hparams = dict(HPARAMS, num_iters=num_iters)
    kw = dict(save_period=save_period, keep=keep)
    j_opt = JOptimizer(hparams, JPRED, j_problem['crt'],
                       checkpoint_dir=str(path / 'jax'), **kw)
    opt = Optimizer(hparams, PRED, problem['crt'],
                    checkpoint_dir=str(path / 'torch'), device='cpu', **kw)
    assert opt.state.step == int(np.asarray(j_opt.state.step))
    if opt.state.step == 0:
        init = jax.tree_util.tree_map(np.asarray, j_opt.state.params)
        # lift the head so the emission (and its gradients) is macroscopic
        head = f'dense_{PRED.net_depth}'
        init[head]['bias'] = init[head]['bias'] + 8.0
        j_opt.state = JTrainState(j_opt.state.step, init, j_opt.state.opt_state,
                                  j_opt.state.tx)
        with torch.no_grad():
            opt.state.params.load_state_dict(
                PRED.params_from_jax(init, device='cpu').state_dict())
    start = {k: v.clone() for k, v in opt.params.state_dict().items()}
    seen = {'jax': [], 'torch': []}

    def record(name):
        def fn(o):
            seen[name].append(int(o.step))
            if o.step == sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)
        return fn

    j_opt.run(NT, j_problem['train_step'], j_problem['crt'],
              log_fns=[JLogFn(record('jax'))], verbose=False)
    opt.run(NT, problem['train_step'], problem['crt'],
            log_fns=[LogFn(record('torch'))], verbose=False)
    return j_opt, opt, seen, start


def listing(path):
    return sorted((p.name for p in path.iterdir() if CKPT_RE.match(p.name)),
                  key=lambda name: int(name.split('_')[1]))


def assert_params_match(j_opt, opt, start, num_updates):
    """The port's params against the reference's after the same updates:
    atol 1e-3 of the most a parameter can move in them (the sum of their
    learning rates; the two gradients differ by float32 reassociation, and
    on this problem the params differ by up to 2.1e-4 of it). Every layer
    must have moved from `start` by more than 10x that tolerance."""
    tx = opt.state.tx
    atol = 1e-3 * sum(tx.lr(k) for k in range(num_updates))
    j_params = jax.tree_util.tree_map(np.asarray, j_opt.params)
    for i, layer in enumerate(opt.params.mlp.layers):
        ref = j_params[f'dense_{i}']
        weight, bias = layer.weight.detach(), layer.bias.detach()
        np.testing.assert_allclose(weight.numpy(), ref['kernel'].T, rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(bias.numpy(), ref['bias'], rtol=0,
                                   atol=atol)
        moved = float((weight - start[f'mlp.layers.{i}.weight']).abs().max())
        assert moved > 10 * atol, f'layer {i} did not move'


@pytest.mark.parametrize('num_iters,save_period,keep', [
    (7, 3, 5), (6, 2, 2), (5, 1, 0), (4, 1, -1), (5, -1, 5)])
def test_save_period_and_keep_match_jax(tmp_path, problem, j_problem,
                                        num_iters, save_period, keep):
    """save_period, the last-step checkpoint and keep pruning (keep <= 0
    keeps all) leave the reference's checkpoint_<step> listing; both
    runs end at the same step, and a new Optimizer of each package on its
    directory restores that step."""
    j_opt, opt, seen, _ = run_both(problem, j_problem, tmp_path, num_iters,
                                   save_period, keep)
    assert seen['torch'] == seen['jax'] == list(range(1, num_iters + 1))
    assert opt.state.step == int(np.asarray(j_opt.state.step)) == num_iters
    assert listing(tmp_path / 'torch') == listing(tmp_path / 'jax')
    assert listing(tmp_path / 'torch')[-1] == f'checkpoint_{num_iters}'
    hparams = dict(HPARAMS, num_iters=3)
    j_again = JOptimizer(hparams, JPRED, j_problem['crt'],
                         checkpoint_dir=str(tmp_path / 'jax'))
    again = Optimizer(hparams, PRED, problem['crt'],
                      checkpoint_dir=str(tmp_path / 'torch'), device='cpu')
    assert again.state.step == int(np.asarray(j_again.state.step)) \
        == num_iters


@pytest.fixture(scope='module')
def preempted(tmp_path_factory, problem, j_problem):
    """A run of 20 steps of each package, preempted by SIGTERM from a
    LogFn at step 5."""
    path = tmp_path_factory.mktemp('preempted')
    j_opt, opt, seen, start = run_both(problem, j_problem, path, 20,
                                       save_period=1000, sigterm_at=5)
    return dict(path=path, j_opt=j_opt, opt=opt, seen=seen, start=start)


def test_sigterm_stop_matches_jax(preempted):
    """SIGTERM from a LogFn at step 5: both packages stop after that step,
    leave checkpoint_5 alone in their directories and reach the same
    params (assert_params_match after 5 updates); the SIGTERM handler is
    back in place."""
    p = preempted
    assert p['seen']['torch'] == p['seen']['jax'] == [1, 2, 3, 4, 5]
    assert p['opt'].state.step == int(np.asarray(p['j_opt'].state.step)) == 5
    assert listing(p['path'] / 'torch') == listing(p['path'] / 'jax') \
        == ['checkpoint_5']
    assert_params_match(p['j_opt'], p['opt'], p['start'], 5)
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_resume_after_sigterm_matches_jax(tmp_path, preempted, problem,
                                          j_problem):
    """New Optimizers of 6 steps on copies of the preempted directories
    resume at step 5 in both packages, run steps 6..11 on the learning
    rates of the restored update count, checkpoint at 6 (save_period
    defaults to num_iters) and at their last step 11, and reach the same
    params (assert_params_match after all 11 updates)."""
    for name in ('jax', 'torch'):
        shutil.copytree(preempted['path'] / name, tmp_path / name)
    j_opt, opt, seen, start = run_both(problem, j_problem, tmp_path, 6)
    assert seen['torch'] == seen['jax'] == list(range(6, 12))
    assert opt.state.step == int(np.asarray(j_opt.state.step)) == 11
    assert listing(tmp_path / 'torch') == listing(tmp_path / 'jax') \
        == ['checkpoint_5', 'checkpoint_6', 'checkpoint_11']
    assert_params_match(j_opt, opt, start, 11)
