"""Fit the April 11 ALMA linear polarization of Sagittarius A*.

PyTorch counterpart of scripts/fit_alma_lp_apr11_sgra_flare.py: fits the
Q-U loop after the X-ray flare (Wielgus et al. 2022) over an inclination
grid x seeds, with tensorboard logging and resumable runs, on the card:

    python -m bhnerf_tpu_torch.scripts.fit_alma_lp_apr11_sgra_flare 60 \\
        --seeds 1 2 --data_path ../data/Apr11_HI.dat

It reads the same configuration (fit_alma_lp_apr11_sgra_flare.yaml beside
this file, a copy of the JAX package's) and takes the same arguments. A
run directory that exists is skipped; with --resume an unfinished run
continues from its latest checkpoint to the configured number of
iterations. DRIVE_CPU=1 in the environment runs on the host. Beyond the
reference's arguments: `--writer memory` keeps the logs in memory
(train.logging.MemoryWriter) instead of writing tensorboard events, for
machines without tensorboardX; `--ngeo` and `--n_fine` size the geodesic
tables (alma.TRACE_DEFAULTS when absent). Each run prints the device of
its parameters as a `# torch device:` line; at its end the script prints
the kernel launches it made as a `# launches:` JSON line. `run_sweep` is the sweep itself, for
callers that bring their own writer (train.logging.MemoryWriter); its
loop, `run_grid`, also runs fit_synthetic_lp_flares' sweep;
`write_synthetic_observation` writes a seeded lightcurve in the data
file's format.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path

import numpy as np

CONFIG_PATH = Path(__file__).with_name('fit_alma_lp_apr11_sgra_flare.yaml')
RUN_NAME = 'inc_{:.1f}.seed_{}'


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('inc', type=int, nargs='+',
                        help='Inclination angle, or (num_blocks, index) to '
                             'split the [4, 80] deg grid')
    parser.add_argument('--start_inc', type=float,
                        help='Start after this angle.')
    parser.add_argument('--seeds', type=int, nargs='+',
                        help='Seeds for network weight initialization.')
    parser.add_argument('--data_path', type=str,
                        default='../data/Apr11_HI.dat',
                        help='Path to ALMA April 11 2017 data (HI band)')
    parser.add_argument('--config_path', type=str, default=str(CONFIG_PATH),
                        help='Path to configuration YAML file')
    parser.add_argument('--resume', action='store_true',
                        help='Resume unfinished runs from their latest '
                             'checkpoint instead of skipping existing run '
                             'directories. Finished runs are still '
                             'skipped.')
    parser.add_argument('--writer', choices=('tensorboard', 'memory'),
                        default='tensorboard',
                        help='tensorboard: event files under log_dir (needs '
                             'tensorboardX); memory: keep the logs in '
                             'memory (no tensorboardX or matplotlib)')
    parser.add_argument('--ngeo', type=int,
                        help='Samples a ray of the geodesic tables '
                             '(default: alma.TRACE_DEFAULTS)')
    parser.add_argument('--n_fine', type=int,
                        help='Fine steps of the geodesic tracer '
                             '(default: alma.TRACE_DEFAULTS)')
    return parser.parse_args(argv)


def split_data(cfg, device='cuda'):
    """The observation of cfg.preprocess, split in time at train_split
    minutes after t_start, and the 'lc' training and validation steps on
    it. Returns (predictor, train, validation), each of the last two a
    dict of step, data and t (hours)."""
    from bhnerf_tpu_torch import alma, units
    from bhnerf_tpu_torch.models.fields import NeRFPredictor
    from bhnerf_tpu_torch.train import TrainStep

    opt_cfg, model = cfg.optimization, cfg.model
    target, t_frames = alma.preprocess_data(
        **dataclasses.asdict(cfg.preprocess))
    split = units.Quantity(cfg.preprocess.t_start, 'hr') + units.Quantity(
        opt_cfg.train_split, 'min')
    t_vals = np.asarray(units.Quantity(t_frames, 'hr').value)
    train_idx = t_vals <= split.to('hr').value
    rmax = model.fov_M / 2
    predictor = NeRFPredictor(scale=rmax, rmin=model.resolved_rmin(),
                              rmax=rmax, z_width=model.z_width)
    parts = []
    for idx in (train_idx, ~train_idx):
        t = units.Quantity(t_vals[idx], 'hr')
        step = TrainStep.image(t, target[idx], predictor,
                               sigma=np.asarray(opt_cfg.sigma), dtype='lc',
                               fused=opt_cfg.fused, device=device)
        parts.append(dict(step=step, data=target[idx], t=t_vals[idx]))
    return predictor, parts[0], parts[1]


def _log_fns(writer, fov_M, log_period, stokes, train, val=None,
             emission_true=None):
    """A fit's LogFns: the training loss every step, and every log_period
    steps the recovered volume (with its mse and psnr against
    `emission_true` when given), the training lightcurve fit and, with
    `val`, the validation one."""
    from bhnerf_tpu_torch.train import LogFn
    fns = [
        LogFn(lambda opt: writer.add_scalar(
            'log_loss/train', np.log10(float(opt.loss)),
            global_step=opt.step)),
        LogFn(writer.recovery_3d(fov_M, emission_true=emission_true),
              log_period=log_period)]
    for name, part in (('training', train), ('validation', val)):
        if part is not None:
            fns.append(LogFn(
                lambda opt, name=name, part=part: writer.plot_lc_datafit(
                    opt, name, part['step'], part['data'], stokes,
                    part['t'], batchsize=20), log_period=log_period))
    return fns


def run_grid(inc_grid, seeds, trace, predictor, train_step, make_log_fns,
             writer_factory, opt_cfg, checkpoint_root, log_root=None,
             resume=False, device='cuda', verbose=True):
    """The sweep loop shared by the fit scripts: every (inclination, seed)
    of the grid trains an Optimizer from opt_cfg.hparams (its seed
    replaced) in checkpoint_root/<run name>, with a writer from
    writer_factory(logdir=...) in log_root/<run name> (the checkpoint
    directory when log_root is None) and the LogFns of
    make_log_fns(writer). A run whose checkpoint directory exists is
    skipped, unless `resume`: then it continues from its latest checkpoint
    to hparams.num_iters. The ray constants of an inclination come from
    trace(inclination) once, when its first run starts, compacted in the
    'gather' layout when the configuration is fused. Returns one record
    per run that trained: run name, inclination, seed, first and last
    step, and the optimizer and writer."""
    from bhnerf_tpu_torch.train import Optimizer, compact_ensemble_args

    hparams = opt_cfg.hparams.asdict()
    say = print if verbose else (lambda *a, **k: None)
    records = []
    for inclination in inc_grid:
        raytracing_args = None
        for seed in seeds:
            runname = RUN_NAME.format(inclination, seed)
            checkpoint_dir = Path(checkpoint_root) / runname
            resuming = checkpoint_dir.exists()
            if resuming and not resume:
                continue  # sweep-level resume (reference alma.py:109)
            if raytracing_args is None:
                raytracing_args = trace(inclination)
                if opt_cfg.fused:
                    raytracing_args = compact_ensemble_args(
                        raytracing_args, predictor, layout='gather')

            hparams['seed'] = seed
            optimizer = Optimizer(hparams, predictor, raytracing_args,
                                  save_period=opt_cfg.save_period,
                                  checkpoint_dir=str(checkpoint_dir),
                                  device=device)
            say(f'# torch device: '
                f'{next(optimizer.params.parameters()).device}', flush=True)
            if resuming:
                # the Optimizer restored the latest checkpoint; num_iters
                # counts from there, so finish the configured total
                done = optimizer.state.step
                remaining = hparams['num_iters'] - done
                say(f'# resume: {runname} from step {done}, {remaining} '
                    f'remaining', flush=True)
                if remaining <= 0:
                    continue  # already finished
                optimizer.num_iters = remaining
            writer = writer_factory(logdir=str(
                checkpoint_dir if log_root is None
                else Path(log_root) / runname))
            optimizer.run(opt_cfg.batchsize, train_step, raytracing_args,
                          log_fns=make_log_fns(writer),
                          scan_chunk=opt_cfg.scan_chunk, verbose=verbose)
            writer.close()
            records.append(dict(run=runname, inclination=inclination,
                                seed=seed, first_step=optimizer.init_step,
                                last_step=optimizer.state.step,
                                optimizer=optimizer, writer=writer))
    return records


def run_sweep(cfg, inc_grid, seeds, writer_factory, resume=False,
              device='cuda', model_overrides=None, verbose=True):
    """Fit every (inclination, seed) of the grid (reference
    scripts/fit_alma_lp_apr11_sgra_flare.py:46-170) by `run_grid`, with
    checkpoints under cfg.optimization.checkpoint_dir and logs under its
    log_dir. The ray constants are traced with `model_overrides` merged
    into the model block (e.g. the tracer's n_fine)."""
    from bhnerf_tpu_torch import alma

    opt_cfg, model = cfg.optimization, cfg.model
    ckpt_root = Path(opt_cfg.checkpoint_dir)
    ckpt_root.mkdir(parents=True, exist_ok=True)
    cfg.to_yaml(ckpt_root / 'config.yml')
    predictor, train, val = split_data(cfg, device)
    rot_angle = np.deg2rad(cfg.preprocess.de_rot_angle + 20.0)
    model_params = dict(model.asdict(), **(model_overrides or {}))

    def trace(inclination):
        return alma.get_raytracing_args(
            np.deg2rad(inclination), model.spin, model_params,
            rot_angle=rot_angle, num_subpixel_rays=model.num_subrays,
            device=device)

    return run_grid(
        inc_grid, seeds, trace, predictor, train['step'],
        lambda writer: _log_fns(writer, model.fov_M, opt_cfg.log_period,
                                ['I', 'Q', 'U'], train, val),
        writer_factory, opt_cfg, ckpt_root, log_root=opt_cfg.log_dir,
        resume=resume, device=device, verbose=verbose)


def write_synthetic_observation(path, t_start=9.30, t_end=11.85,
                                cadence_s=12.0, period_min=70.0, seed=0):
    """A seeded stand-in for the ALMA data file, in the CSV format that
    alma.preprocess_data reads (an index column, then time in hours, I,
    Q and U in Jy): a constant intensity, the shadow's constant linear
    polarization plus a Q-U loop of `period_min` minutes, with Gaussian
    noise, sampled every `cadence_s` seconds. Returns the path as a
    string."""
    rng = np.random.default_rng(seed)
    t = np.arange(t_start, t_end, cadence_s / 3600.0)
    phase = 2 * np.pi * (t - t_start) * 60.0 / period_min
    shadow = 0.16 * np.array([np.cos(2 * np.deg2rad(-37.0)),
                              np.sin(2 * np.deg2rad(-37.0))])
    q = shadow[0] + 0.1 * np.cos(phase) + 0.005 * rng.standard_normal(t.size)
    u = shadow[1] + 0.1 * np.sin(phase) + 0.005 * rng.standard_normal(t.size)
    i = 2.4 + 0.01 * rng.standard_normal(t.size)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'w') as f:
        f.write(',time,I,Q,U\n')
        for k, row in enumerate(zip(t, i, q, u)):
            f.write(f'{k},' + ','.join(f'{x:.17g}' for x in row) + '\n')
    return str(path)


def launch_counts():
    """The kernel launches of this process so far: the fused forward and
    backward and the geodesic tracer."""
    from bhnerf_tpu_torch.geodesics import integrator
    from bhnerf_tpu_torch.ops import fused
    return {'render_fwd': fused.render_fwd.launches,
            'render_bwd': fused.render_bwd.launches,
            'trace_rays': integrator.trace_rays.launches}


def main(argv=None):
    import json

    from bhnerf_tpu_torch import config as config_lib
    from bhnerf_tpu_torch.train.logging import MemoryWriter, SummaryWriter

    args = parse_args(argv)
    if args.writer == 'tensorboard':
        # fail fast: the run's logging needs tensorboardX
        import tensorboardX  # noqa: F401
    device = 'cpu' if os.environ.get('DRIVE_CPU') else 'cuda'
    cfg = config_lib.RunConfig.from_yaml(args.config_path)
    if args.data_path:
        cfg.preprocess.data_path = args.data_path
    inc_grid = config_lib.inclination_grid(args.inc, args.start_inc)
    seeds = args.seeds if args.seeds else [cfg.optimization.hparams.seed]
    overrides = {k: v for k, v in (('ngeo', args.ngeo),
                                   ('n_fine', args.n_fine)) if v}
    extra = {'model_overrides': overrides} if overrides else {}
    writer = SummaryWriter if args.writer == 'tensorboard' else MemoryWriter
    run_sweep(cfg, inc_grid, seeds, writer, resume=args.resume,
              device=device, **extra)
    print(f'# launches: {json.dumps(launch_counts())}', flush=True)


if __name__ == '__main__':
    main()
