"""The production ALMA fit's chunked ensemble training and its chi^2
against bhnerf_tpu, at a small size on the host.

The fit is the production drive's (scripts/drive_alma_production.py):
the ALMA yaml's predictor, lightcurve ('lc' on I, Q and U), batch 6, lr
schedule and seed 4, on the seeded Apr11-like lightcurve, with a
10-variant sub-pixel ensemble of seeded 8x8x16 ray tables (the drive's
rays cost too much here), trained through the port's real sweep loop
(`fit.run_grid`: each package compacts its own ensemble, Optimizer.run
in chunks of 10) for 40 steps, preempted after its checkpoint at step 20
and resumed through run_grid's resume path. The JAX side runs its chunked
ensemble step (`make_scan_step` with num_variants=10 on the stacked
ensemble, the XLA path) with the keys its Optimizer would use for the same
run and resume (the seed folded with the starting step, one split a
chunk); the port is handed the frame batches and variants those keys
draw, and starts from the JAX package's seed-4 params. Tolerances: the
40 losses rtol 1e-4; each final parameter tensor's distance from the JAX
package's at most 5% of the distance the JAX package moved it from the
shared start (1.5% at most here: the packages' posenc differ by ~1e-6,
and Adam's normalised steps turn that into whole steps where a gradient
is near 0); chi^2 of
one checkpoint through both packages' chi2_lightcurves rtol 1e-5; chi^2
of each package's own trained run rtol 1e-4.

Run as a script, the module evaluates a finished port run with both
packages' chi2_lightcurves on the same ray tables (traced once by the
port on the host, the jitter seeded with 0):

    python tests/test_torch_production_parity.py RUN_DIR CONFIG CSV \\
        [--num 16] [--variants 2] [--n_fine 1024]

CONFIG and CSV are the drive's config.yaml and apr11_synth.csv; one JSON
line gives both chi^2 of the training and validation frames.
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import pytest

if __name__ == '__main__':      # run as a script: the checkout's packages
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from bhnerf_tpu import alma as j_alma
from bhnerf_tpu import units as j_units
from bhnerf_tpu.models import NeRFPredictor as JPredictor
from bhnerf_tpu.train import TrainState as JTrainState
from bhnerf_tpu.train import TrainStep as JTrainStep
from bhnerf_tpu.train import make_optimizer as j_make_optimizer
from bhnerf_tpu.train import step as j_step
from bhnerf_tpu.train.state import save_checkpoint as j_save_checkpoint

import torch

from bhnerf_tpu_torch import alma, config, units
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.ops import fused
from bhnerf_tpu_torch.scripts import drive_alma_production as prod
from bhnerf_tpu_torch.scripts import fit_alma_lp_apr11_sgra_flare as fit
from bhnerf_tpu_torch.train import LogFn, Optimizer, restore_params, step
from bhnerf_tpu_torch.train.logging import MemoryWriter
from bhnerf_tpu_torch.train.state import latest_checkpoint_step
from _torch_cores import module_cores_per_worker  # noqa: F401 (autouse)

STEPS, STOP, CHUNK, VARIANTS, INC = 40, 20, 10, 10, 60.0


def _jax_rt(rt):
    return j_step.RayTracingArgs(
        **{k: jnp.asarray(np.asarray(getattr(rt, k))) for k in
           ('coords', 'Omega', 'J', 'g', 'dtau', 'Sigma', 't_geos_rel')},
        t_injection=jnp.zeros((), jnp.float32), t_start_obs=rt.t_start_obs,
        t_to_M=rt.t_to_M, t_units=j_units.hr)


def seeded_ensemble(t_start_obs, num_variants=VARIANTS, shape=(8, 8, 16),
                    seed=0):
    """Seeded ray tables with the I, Q and U weights of a polarized source
    (a positive I factor, Q and U at 30% of it along an EVPA that turns
    with the azimuth), one a variant."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    rts = []
    for _ in range(num_variants):
        x, y = rng.uniform(-20, 20, (2, *shape))
        I = rng.uniform(0.5, 1.5, shape)
        chi = 0.5 * np.arctan2(y, x)
        rts.append(step.RayTracingArgs(
            coords=f32(np.stack([x, y, rng.uniform(-6, 6, shape)])),
            Omega=f32(rng.uniform(0.005, 0.07, shape)),
            J=f32(np.stack([I, 0.3 * I * np.cos(2 * chi),
                            0.3 * I * np.sin(2 * chi)])),
            g=f32(rng.uniform(0.5, 1.5, shape)),
            dtau=f32(rng.uniform(0.5, 1.0, shape)),
            Sigma=f32(rng.uniform(10, 100, shape)),
            t_geos_rel=f32(rng.uniform(0, 50, shape)),
            t_injection=f32(0.0), t_start_obs=t_start_obs, t_to_M=100.0,
            t_units=units.hr))
    return rts


def to_jax_checkpoint(run_dir, out_dir):
    """The port's latest checkpoint under run_dir as a checkpoint of the
    JAX package in out_dir (its predictor yaml and the params, weight.T
    as kernel, at the same step). Returns out_dir."""
    from bhnerf_tpu_torch.train.state import restore_params as restore
    predictor = NeRFPredictor.from_yml(run_dir)
    params = restore(run_dir, predictor.init_params(device='cpu'))
    tree = {f'dense_{i}': {
        'kernel': jnp.asarray(layer.weight.detach().numpy().T),
        'bias': jnp.asarray(layer.bias.detach().numpy())}
        for i, layer in enumerate(params.mlp.layers)}
    jpred = JPredictor.from_yml(run_dir)
    jpred.save_params(out_dir)
    j_save_checkpoint(out_dir, JTrainState.create(tree, j_make_optimizer(10)),
                      latest_checkpoint_step(run_dir))
    return out_dir


def chi2_both(rts, run_dir, t_hr, target, sigma, batchsize=20):
    """chi^2 of the port run's latest checkpoint on frames t_hr through
    the port's and the JAX package's chi2_lightcurves, on the same ray
    tables (the port's RayTracingArgs on the host). Returns (port, jax)."""
    port = alma.chi2_lightcurves(rts, run_dir, units.Quantity(t_hr, 'hr'),
                                 target, sigma=sigma, batchsize=batchsize)
    with tempfile.TemporaryDirectory() as tmp:
        jdir = to_jax_checkpoint(run_dir, os.path.join(tmp, 'jax'))
        ref = j_alma.chi2_lightcurves(
            [_jax_rt(rt) for rt in rts], jdir,
            j_units.Quantity(np.asarray(t_hr), 'hr'), target, sigma=sigma,
            batchsize=batchsize)
    return float(port), float(ref)


def _split(cfg):
    target, t_frames = alma.preprocess_data(
        **dataclasses.asdict(cfg.preprocess))
    split = units.Quantity(cfg.preprocess.t_start, 'hr') + units.Quantity(
        cfg.optimization.train_split, 'min')
    t_hr = np.asarray(units.Quantity(t_frames, 'hr').value)
    train = t_hr <= split.to('hr').value
    return target, t_hr, train


def _jax_draws(key, chunk, nt, batchsize):
    """The frame batches and variants make_scan_step's body draws from a
    chunk's key."""
    draws = []
    for k in jax.random.split(key, chunk):
        k_batch, k_var = jax.random.split(k)
        idx = jax.random.choice(k_batch, nt, (batchsize,), replace=False)
        var = jax.random.randint(k_var, (), 0, VARIANTS)
        draws.append((torch.as_tensor(np.array(idx), dtype=torch.int64),
                      int(var)))
    return draws


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('production')
    csv = tmp / 'apr11.csv'
    prod.make_synthetic_csv(csv)
    cfg = config.RunConfig.from_yaml(fit.CONFIG_PATH)
    cfg.preprocess.data_path = str(csv)
    opt_cfg = cfg.optimization
    opt_cfg.hparams.num_iters = STEPS
    opt_cfg.save_period = STOP
    opt_cfg.scan_chunk = CHUNK
    opt_cfg.checkpoint_dir = str(tmp / 'ckpt')
    assert opt_cfg.fused and opt_cfg.batchsize == 6
    hp = opt_cfg.hparams
    target, t_hr, train = _split(cfg)
    predictor, train_part, _ = fit.split_data(cfg, 'cpu')
    rts = seeded_ensemble(cfg.model.t_start_obs)
    sigma = np.asarray(opt_cfg.sigma)

    # the JAX package: its own compaction, the chunked ensemble step with
    # its Optimizer's keys for a run preempted at STOP and resumed
    jpred = JPredictor(scale=predictor.scale, rmin=predictor.rmin,
                       rmax=predictor.rmax, z_width=predictor.z_width)
    j_crts = j_step.compact_ensemble_args([_jax_rt(rt) for rt in rts], jpred,
                                          tile=fused.TILE_N, layout='gather')
    j_stack = j_step.stack_ensemble(j_crts)
    j_train = JTrainStep.image(j_units.Quantity(t_hr[train], 'hr'),
                               target[train], jpred, sigma=sigma,
                               dtype='lc', fused=False)
    jparams = jpred.init_params(seed=hp.seed)
    np_params = jax.tree_util.tree_map(np.array, jparams)
    j_state = JTrainState.create(jparams, j_make_optimizer(
        STEPS, hp.lr_init, hp.lr_final))
    scan = j_step.make_scan_step(jpred, kind='image', dtype='lc',
                                 fused=False, batchsize=opt_cfg.batchsize,
                                 chunk=CHUNK, num_variants=VARIANTS)
    nt = int(train.sum())
    j_losses, draws = [], []
    for init_step in (1, STOP + 1):
        key = jax.random.fold_in(jax.random.PRNGKey(hp.seed), init_step)
        for _ in range(STOP // CHUNK):
            key, sub = jax.random.split(key)
            draws += _jax_draws(sub, CHUNK, nt, opt_cfg.batchsize)
            j_state, losses = scan(j_state,
                                   *j_train.args[0].device_args, sub,
                                   j_stack, 1.0)
            j_losses += list(np.asarray(losses))

    # the port: run_grid from the JAX params on those draws, preempted
    # after its checkpoint at STOP (the draws run out), then resumed
    losses = []
    remaining = iter(draws)

    def draw(self, batchsize, train_step, num_variants):
        assert num_variants == VARIANTS
        if len(losses) == STOP and not resumed:
            raise KeyboardInterrupt
        return next(remaining)

    def sweep(resume):
        return fit.run_grid(
            [INC], [hp.seed], lambda inc: rts, predictor, train_part['step'],
            lambda writer: [LogFn(lambda opt: losses.append(float(opt.loss)))],
            MemoryWriter, opt_cfg, opt_cfg.checkpoint_dir, resume=resume,
            device='cpu', verbose=False)

    run_dir = os.path.join(opt_cfg.checkpoint_dir,
                           fit.RUN_NAME.format(INC, hp.seed))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Optimizer, '_draw', draw)
        mp.setattr(NeRFPredictor, 'init_params',
                   lambda self, generator=None, device='cuda',
                   dtype=torch.float32: self.params_from_jax(
                       np_params, device=device, dtype=dtype))
        resumed = False
        leg1, = sweep(False)
        assert (leg1['last_step'], latest_checkpoint_step(run_dir)) == (
            STOP, STOP)
        resumed = True
        leg2, = sweep(True)
    assert (leg2['first_step'], leg2['last_step']) == (STOP + 1, STEPS)
    assert latest_checkpoint_step(run_dir) == STEPS
    return dict(cfg=cfg, rts=rts, run_dir=run_dir, losses=losses,
                j_losses=j_losses, j_state=j_state, jpred=jpred,
                target=target, t_hr=t_hr, train=train, sigma=sigma,
                draws=draws, tmp=tmp, init_params=np_params)


def test_chunked_ensemble_fit_tracks_jax(runs):
    """40 chunked steps over 10 variants with a resume at 20: the port's
    losses and final params against the JAX package's chunked ensemble
    step; the draws visit most variants and the loss falls."""
    assert len({v for _, v in runs['draws']}) >= 8
    np.testing.assert_allclose(runs['losses'], runs['j_losses'], rtol=1e-4)
    assert np.mean(runs['j_losses'][-10:]) < np.mean(runs['j_losses'][:10])
    params = restore_params(runs['run_dir'])
    ref = jax.tree_util.tree_map(np.asarray, runs['j_state'].params)
    init = runs['init_params']
    for i in range(len(ref)):
        for name, got, want in (
                ('weight', params[f'mlp.layers.{i}.weight'].numpy(),
                 ref[f'dense_{i}']['kernel'].T),
                ('bias', params[f'mlp.layers.{i}.bias'].numpy(),
                 ref[f'dense_{i}']['bias'])):
            start = (init[f'dense_{i}']['kernel'].T if name == 'weight'
                     else init[f'dense_{i}']['bias'])
            moved = np.linalg.norm(want - start)
            assert moved > 0
            assert np.linalg.norm(got - want) <= 0.05 * moved, (i, name)


@pytest.mark.parametrize('part', ['train', 'val'])
def test_checkpoint_chi2_matches_jax(runs, part):
    """chi^2 of the port's step-40 checkpoint through both packages'
    chi2_lightcurves on the same ensemble; and chi^2 of the JAX package's
    own run, saved as its checkpoint, against the port's."""
    idx = runs['train'] if part == 'train' else ~runs['train']
    t_hr, target = runs['t_hr'][idx], runs['target'][idx]
    port, ref = chi2_both(runs['rts'], runs['run_dir'], t_hr, target,
                          runs['sigma'])
    assert np.isfinite(port) and port > 0
    np.testing.assert_allclose(port, ref, rtol=1e-5)
    jdir = str(runs['tmp'] / f'jax_run_{part}')
    runs['jpred'].save_params(jdir)
    j_save_checkpoint(jdir, runs['j_state'], STEPS)
    own = j_alma.chi2_lightcurves(
        [_jax_rt(rt) for rt in runs['rts']], jdir,
        j_units.Quantity(t_hr, 'hr'), target, sigma=runs['sigma'])
    np.testing.assert_allclose(port, float(own), rtol=1e-4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('run_dir')
    ap.add_argument('config')
    ap.add_argument('csv')
    ap.add_argument('--num', type=int, default=16)
    ap.add_argument('--variants', type=int, default=2)
    ap.add_argument('--n_fine', type=int, default=1024)
    args = ap.parse_args(argv)
    cfg = config.RunConfig.from_yaml(args.config)
    cfg.preprocess.data_path = args.csv
    target, t_hr, train = _split(cfg)
    model = dict(cfg.model.asdict(), num_alpha=args.num, num_beta=args.num,
                 n_fine=args.n_fine)
    rts = alma.get_raytracing_args(
        np.deg2rad(INC), cfg.model.spin, model,
        rot_angle=np.deg2rad(cfg.preprocess.de_rot_angle + 20.0),
        num_subpixel_rays=args.variants,
        rng=np.random.default_rng(0), device='cpu')
    sigma = np.asarray(cfg.optimization.sigma)
    out = dict(run_dir=args.run_dir, step=latest_checkpoint_step(
        args.run_dir), rays=args.num, variants=args.variants,
        tracer=alma.trace_sizes(model))
    for part, idx in (('train', train), ('val', ~train)):
        port, ref = chi2_both(rts, args.run_dir, t_hr[idx], target[idx],
                              sigma)
        out[f'chi2_{part}'] = {'port': port, 'jax': ref}
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
