"""Fit synthetic linear-polarization flare data of Sagittarius A*.

PyTorch counterpart of scripts/fit_synthetic_lp_flares.py (the
reference's Fit_Synthetic_LP_Flares.py): fits the Q and U lightcurves that
generate_synthetic_lightcurves wrote over an inclination grid x seeds on
the card, with the flare's 3D truth as the recovery's reference:

    python -m bhnerf_tpu_torch.scripts.fit_synthetic_lp_flares \\
        data/hotspot_i60.yaml 60 --seeds 1 2

The first argument is the simulation's yaml; the recovery configuration
(--config_path, fit_synthetic_lp_flares.yaml beside this file) is merged
over its model block, key by key. Frames up to train_split minutes after
t_start_obs train the fit. Runs live in recovery/<name>/<run> beside the
lightcurve file, with their tensorboard logs; a run directory that exists
is skipped. DRIVE_CPU=1 in the environment runs on the host. Beyond the
reference's arguments, `--writer memory` keeps the logs in memory
(train.logging.MemoryWriter) instead of writing tensorboard events, for
machines without tensorboardX, and then prints a `# summary:` JSON line
for each run that trained (its losses, the last psnr against the flare
and the chi^2 of its last checkpoint on the training frames,
alma.chi2_lightcurves); at its end the script prints its kernel
launches as a `# launches:` JSON line. `run_sweep` is the sweep itself,
for callers that bring their own writer (train.logging.MemoryWriter);
its loop is the ALMA fit script's `run_grid`.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

CONFIG_PATH = Path(__file__).with_name('fit_synthetic_lp_flares.yaml')


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('yaml_path', type=str,
                        help='Path to data configuration (.yaml) with '
                             'lightcurve_path / flare_path / name keys')
    parser.add_argument('inc', type=int, nargs='+',
                        help='Inclination angle, or (num_blocks, index)')
    parser.add_argument('--start_inc', type=float)
    parser.add_argument('--seeds', type=int, nargs='+')
    parser.add_argument('--config_path', type=str, default=str(CONFIG_PATH))
    parser.add_argument('--writer', choices=('tensorboard', 'memory'),
                        default='tensorboard',
                        help='tensorboard: event files beside the runs '
                             '(needs tensorboardX); memory: keep the logs '
                             'in memory and print a summary of each run')
    return parser.parse_args(argv)


def load_fit(yaml_path, config_path=CONFIG_PATH, device='cuda'):
    """The fit of a simulation (reference :44-115): the recovery
    configuration, the merged model block, the training split of the
    lightcurves, the predictor and its 'lc' training step, the flare's 3D
    truth (a Grid3D scaled by emission_scale; None without a flare file)
    and the recovery directory, where params.yaml records the simulation
    and the merged model. Returns a dict of those."""
    import pandas as pd
    import torch
    import yaml

    from bhnerf_tpu_torch import config as config_lib
    from bhnerf_tpu_torch import constants, units, utils
    from bhnerf_tpu_torch.models.fields import NeRFPredictor
    from bhnerf_tpu_torch.train import TrainStep

    simulation_params = yaml.safe_load(Path(yaml_path).read_text())
    recovery = config_lib.RunConfig.from_yaml(config_path)
    recovery_raw = yaml.safe_load(Path(config_path).read_text())
    # dict-union merge: only the keys the recovery yaml sets override the
    # simulation's model (reference Fit_Synthetic...py:59)
    model_params = dict(simulation_params.get('model', {}))
    model_params.update(recovery_raw.get('model', {}))
    opt_cfg = recovery.optimization
    stokes = opt_cfg.stokes

    data_path = Path(simulation_params['lightcurve_path'])
    lightcurves_df = pd.read_csv(data_path)
    target = np.array(lightcurves_df[stokes])
    t_vals = np.array(lightcurves_df['t'])
    split_hr = model_params['t_start_obs'] + opt_cfg.train_split / 60.0
    train_idx = t_vals <= split_hr

    spin, fov_M = model_params['spin'], model_params['fov_M']
    rmax = fov_M / 2
    rmin = model_params['rmin']
    if rmin == 'ISCO':
        rmin = float(constants.isco_pro(spin))
    model_params.update(rmax=rmax, rmin=rmin)
    predictor = NeRFPredictor(
        scale=rmax, rmin=rmin, rmax=rmax, z_width=model_params['z_width'],
        posenc_var=model_params.get('recovery_scale', 1.0) / fov_M)
    train = dict(data=target[train_idx], t=t_vals[train_idx])
    train['step'] = TrainStep.image(
        units.Quantity(train['t'], 'hr'), train['data'], predictor,
        sigma=np.asarray(opt_cfg.sigma), dtype='lc', fused=opt_cfg.fused,
        device=device)

    sim_name = simulation_params.get('name', data_path.stem)
    recovery_dir = data_path.parent / 'recovery' / sim_name
    recovery_dir.mkdir(parents=True, exist_ok=True)
    with open(recovery_dir / 'params.yaml', 'w') as f:
        yaml.dump({'simulation': simulation_params,
                   'recovery': {'model': model_params}}, f,
                  default_flow_style=False)

    # the flare's 3D truth for the psnr of the recovered volume
    emission_flare = None
    flare_path = simulation_params.get('flare_path')
    if flare_path and Path(flare_path).exists():
        blob = np.load(flare_path)
        emission_flare = utils.Grid3D(
            model_params.get('emission_scale', 1.0)
            * torch.as_tensor(blob['data']),
            tuple(blob['start']), tuple(blob['stop']))
    return dict(opt_cfg=opt_cfg, model_params=model_params, stokes=stokes,
                predictor=predictor, train=train,
                emission_flare=emission_flare, recovery_dir=recovery_dir)


def run_sweep(yaml_path, inc_grid, seeds, writer_factory,
              config_path=CONFIG_PATH, device='cuda', model_overrides=None,
              verbose=True):
    """Fit every (inclination, seed) of the grid (reference :117-152) by
    the ALMA script's `run_grid`, in the recovery directory of `load_fit`:
    each run logs the flare's truth as emission/true, then the training
    loss every step and every log_period steps the recovered volume with
    its psnr against the flare and the training lightcurve fit. The ray
    constants are traced with `model_overrides` merged into the model
    block (e.g. the tracer's n_fine). Returns run_grid's records with the
    dict of load_fit under 'fit' in each."""
    from bhnerf_tpu_torch import alma
    from bhnerf_tpu_torch.scripts.fit_alma_lp_apr11_sgra_flare import (
        _log_fns, run_grid)

    fit = load_fit(yaml_path, config_path, device)
    opt_cfg, stokes = fit['opt_cfg'], fit['stokes']
    model_params = dict(fit['model_params'], **(model_overrides or {}))
    truth = fit['emission_flare']

    def trace(inclination):
        return alma.get_raytracing_args(
            np.deg2rad(inclination), model_params['spin'], model_params,
            stokes, num_subpixel_rays=model_params.get('num_subrays', 1),
            device=device)

    def log_fns(writer):
        if truth is not None:
            writer.add_volume('emission/true', truth.data.numpy(), 0)
        return _log_fns(writer, model_params['fov_M'], opt_cfg.log_period,
                        stokes, fit['train'], emission_true=truth)

    records = run_grid(inc_grid, seeds, trace, fit['predictor'],
                       fit['train']['step'], log_fns, writer_factory,
                       opt_cfg, fit['recovery_dir'], device=device,
                       verbose=verbose)
    for r in records:
        r['fit'] = fit
    return records


def summary(record):
    """A run's summary: steps, the mean log10 training loss of its first and
    last 20 steps, the first and last logged psnr against the flare (None
    without one) and the chi^2 of its last checkpoint on the training
    frames over its ensemble (alma.chi2_lightcurves)."""
    from bhnerf_tpu_torch import alma, units

    w, opt, fit = record['writer'], record['optimizer'], record['fit']
    losses = [v for _, v in w.scalars['log_loss/train']]
    psnr = w.scalars.get('emission/psnr')
    train = fit['train']
    chi2 = alma.chi2_lightcurves(
        opt.raytracing_args, opt.checkpoint_dir,
        units.Quantity(train['t'], 'hr'), train['data'],
        sigma=np.asarray(fit['opt_cfg'].sigma))
    return {'run': record['run'], 'first_step': record['first_step'],
            'last_step': record['last_step'],
            'log10_loss_first20': float(np.mean(losses[:20])),
            'log10_loss_last20': float(np.mean(losses[-20:])),
            'psnr_first': psnr[0][1] if psnr else None,
            'psnr': psnr[-1][1] if psnr else None,
            'chi2_train': float(chi2)}


def main(argv=None):
    import json

    from bhnerf_tpu_torch import config as config_lib
    from bhnerf_tpu_torch.scripts.fit_alma_lp_apr11_sgra_flare import (
        launch_counts)
    from bhnerf_tpu_torch.train.logging import MemoryWriter, SummaryWriter

    args = parse_args(argv)
    if args.writer == 'tensorboard':
        # fail fast: the run's logging needs tensorboardX
        import tensorboardX  # noqa: F401
    device = 'cpu' if os.environ.get('DRIVE_CPU') else 'cuda'
    recovery = config_lib.RunConfig.from_yaml(args.config_path)
    inc_grid = config_lib.inclination_grid(args.inc, args.start_inc)
    seeds = args.seeds if args.seeds else [recovery.optimization.hparams.seed]
    memory = args.writer == 'memory'
    records = run_sweep(args.yaml_path, inc_grid, seeds,
                        MemoryWriter if memory else SummaryWriter,
                        config_path=args.config_path, device=device)
    if memory:
        for record in records:
            print(f'# summary: {json.dumps(summary(record))}', flush=True)
    print(f'# launches: {json.dumps(launch_counts())}', flush=True)


if __name__ == '__main__':
    main()
