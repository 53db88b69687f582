"""One production ALMA fit with a preemption in the middle of it.

PyTorch counterpart of scripts/drive_alma_production.py: runs the fit
script (bhnerf_tpu_torch.scripts.fit_alma_lp_apr11_sgra_flare, the real
entry point) at the production settings (50,000 iterations, a 10-variant
sub-pixel ensemble, batch 6, log_period 500, periodic checkpoints, the
chunked loop of the configuration's scan_chunk) on a seeded stand-in for
the Apr 11 lightcurve (`make_synthetic_csv`: the data file is not in the
repository), on the card:

    python -m bhnerf_tpu_torch.scripts.drive_alma_production \\
        [--num-iters N] [--ngeo K] [--n_fine K] [--work DIR]

Leg 1 starts the fit in a child process and sends it SIGTERM once its
first periodic checkpoint exists; the fit must exit cleanly at a
checkpoint below N. Leg 2 runs the fit's --resume, which must continue
from that step and finish at checkpoint_N. Then the train and
validation chi^2 of the finished fit are evaluated over a 10-variant
ensemble (alma.chi2_lightcurves), and one JSON line is printed with the
reference's keys, the card's name and power limit and the kernel
launches of each part. The children log with `--writer memory`: the
card's machine has no tensorboardX. DRIVE_CPU=1 in the environment runs
everything on the host at 16x16 rays and 2 variants, as the reference's
rehearsal does; --ngeo and --n_fine size the geodesic tables of the fit
and of the evaluation (the tracer's defaults, alma.TRACE_DEFAULTS, when
absent).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
FIT_MODULE = 'bhnerf_tpu_torch.scripts.fit_alma_lp_apr11_sgra_flare'
INCLINATION = 60
ENSEMBLE = 10
LEG_TIMEOUT_S = 3000


def make_synthetic_csv(path):
    """Apr11-equivalent lightcurve: 4 s cadence over the fit window, a
    ~70 min QU loop + the constant shadow polarization + Faraday rotation
    that preprocess_data expects to remove (the reference's file to the
    last digit)."""
    import pandas as pd
    rng = np.random.default_rng(11)
    t = 9.30 + np.arange(2400) * 4.0 / 3600        # 9.30h .. 11.97h
    period = 70.0 / 60.0                            # hr (Wielgus QU loop)
    phase = 2 * np.pi * t / period
    de_rot = np.deg2rad(32.2)
    q_int = 0.08 * np.cos(2 * phase) * np.exp(-(t - 10.2) ** 2 / 1.0)
    u_int = 0.08 * np.sin(2 * phase) * np.exp(-(t - 10.2) ** 2 / 1.0)
    # forward-rotate by the Faraday angle the pipeline de-rotates
    Q = q_int * np.cos(2 * de_rot) - u_int * np.sin(2 * de_rot)
    U = q_int * np.sin(2 * de_rot) + u_int * np.cos(2 * de_rot)
    chi_sha = np.deg2rad(-37.0)
    Q = Q + 0.16 * np.cos(2 * chi_sha) + 1e-3 * rng.standard_normal(t.size)
    U = U + 0.16 * np.sin(2 * chi_sha) + 1e-3 * rng.standard_normal(t.size)
    I = 2.4 + 0.05 * np.cos(phase) + 1e-3 * rng.standard_normal(t.size)
    pd.DataFrame({'time': t, 'I': I, 'Q': Q, 'U': U}).to_csv(path)


def production_config(num_iters, work):
    """The fit's configuration (fit_alma_lp_apr11_sgra_flare.yaml) at the
    production settings as a dict: logs and checkpoints under `work`,
    num_iters iterations, a checkpoint every min(5000, num_iters // 3)
    steps and the 10-variant ensemble (16x16 rays and 2 variants under
    DRIVE_CPU)."""
    import yaml

    from bhnerf_tpu_torch.scripts import fit_alma_lp_apr11_sgra_flare as fit
    cfg = yaml.safe_load(Path(fit.CONFIG_PATH).read_text())
    cfg['optimization']['log_dir'] = os.path.join(work, 'runs')
    cfg['optimization']['checkpoint_dir'] = os.path.join(work, 'ckpt')
    cfg['optimization']['save_period'] = min(5000, max(num_iters // 3, 1))
    cfg['optimization']['hparams']['num_iters'] = num_iters
    cfg['model']['num_subrays'] = ENSEMBLE
    if os.environ.get('DRIVE_CPU'):            # the rehearsal's shrink
        cfg['model']['num_alpha'] = cfg['model']['num_beta'] = 16
        cfg['model']['num_subrays'] = 2
    return cfg


def _tail(path, nbytes=2000):
    with open(path, 'r', errors='replace') as f:
        return f.read()[-nbytes:]


def _launches(text):
    """The kernel launches the fit printed as its `# launches:` line."""
    m = re.search(r'# launches: (\{.*\})', text)
    if not m:
        raise RuntimeError('the fit printed no launch counts')
    return json.loads(m.group(1))


def _check_device(log_path, child):
    """True once the child's `# torch device:` line (the device of its
    parameters) is complete; kills the child and raises unless it says
    cuda (DRIVE_CPU: cpu)."""
    with open(log_path, 'r', errors='replace') as f:
        head = f.read(262144)
    lines = [line for line in head.splitlines(keepends=True)
             if line.startswith('# torch device:') and line.endswith('\n')]
    if not lines:
        return False
    want = 'cpu' if os.environ.get('DRIVE_CPU') else 'cuda'
    if want not in lines[0]:
        child.kill()
        raise RuntimeError(f'the fit is not on {want}: {lines[0].strip()!r}')
    return True


def run_legs(fit_cmd, env, run_dir, save_period, num_iters, work,
             log=print):
    """Leg 1: the fit in a child process, SIGTERM as soon as
    checkpoint_<save_period> appears (within 0.1 s: the reference waits
    1 s more, which at a small size can outlast the next chunk), a clean
    exit at a checkpoint below num_iters. Leg 2: the fit's --resume,
    which must say `# resume: <run> from step <stop>` and finish at
    checkpoint_<num_iters>. Returns (stop step, leg 1 launches, leg 2
    launches)."""
    from bhnerf_tpu_torch.train.state import latest_checkpoint_step

    # the child's output goes to a file, not a pipe: a full pipe would
    # block the child on write() before its first checkpoint
    t0 = time.time()
    leg1_log = os.path.join(work, 'fit_leg1.log')
    with open(leg1_log, 'w') as logf:
        child = subprocess.Popen(fit_cmd, stdout=logf,
                                 stderr=subprocess.STDOUT, text=True,
                                 env=env, cwd=str(REPO))
    try:
        first_ckpt = os.path.join(run_dir, f'checkpoint_{save_period}')
        device_checked = False
        while not os.path.exists(first_ckpt):
            if child.poll() is not None:
                log(_tail(leg1_log))
                raise RuntimeError('the fit died before its first periodic '
                                   'checkpoint')
            if time.time() - t0 > LEG_TIMEOUT_S:
                log(_tail(leg1_log))
                raise RuntimeError('timeout before the first periodic '
                                   'checkpoint')
            if not device_checked:
                device_checked = _check_device(leg1_log, child)
            time.sleep(0.1)
        child.send_signal(signal.SIGTERM)
        child.wait(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise RuntimeError(f'fit rc={child.returncode}:\n{_tail(leg1_log)}')
    stop_step = latest_checkpoint_step(run_dir)
    if not stop_step or stop_step >= num_iters:
        raise RuntimeError(f'leg 1 stopped at step {stop_step}, not below '
                           f'{num_iters}')
    leg1_launches = _launches(open(leg1_log, errors='replace').read())
    log(f'# leg1: SIGTERM at step {stop_step} ({time.time() - t0:.0f}s in), '
        f'clean exit; launches {leg1_launches}')

    # leg 2 resumes mid-run through the entry point's --resume (without it
    # the sweep would skip the existing run directory)
    leg2_log = os.path.join(work, 'fit_leg2.log')
    with open(leg2_log, 'w') as logf:
        r = subprocess.run(fit_cmd + ['--resume'], stdout=logf,
                           stderr=subprocess.STDOUT, text=True, env=env,
                           cwd=str(REPO), timeout=LEG_TIMEOUT_S)
    leg2_out = open(leg2_log, errors='replace').read()
    if r.returncode != 0:
        raise RuntimeError(f'fit --resume rc={r.returncode}:\n'
                           f'{leg2_out[-2000:]}')
    m = re.search(r'# resume: \S+ from step (\d+), (\d+) remaining',
                  leg2_out)
    if not m:
        raise RuntimeError('fit --resume never took the resume path')
    if int(m.group(1)) != stop_step:
        raise RuntimeError(f'leg 2 resumed at step {m.group(1)}, not at '
                           f'leg 1\'s {stop_step}')
    final = latest_checkpoint_step(run_dir)
    if final != num_iters:
        raise RuntimeError(f'leg 2 ended at checkpoint {final}, not '
                           f'{num_iters}')
    leg2_launches = _launches(leg2_out)
    log(f'{m.group(0)}; finished at checkpoint_{final}; launches '
        f'{leg2_launches}')
    return stop_step, leg1_launches, leg2_launches


def evaluate(cfg_path, csv_path, run_dir, inc, device, model_overrides=None):
    """chi^2 of the finished fit on its training and validation frames
    over a fresh sub-pixel ensemble of the configuration's size
    (reference scripts/drive_alma_production.py:179-213). Returns a dict
    of chi2_train, chi2_val, the ensemble (raytracing_args), the
    training frames' times in hours (t_train) and the tracer's sizes
    (tracer)."""
    from bhnerf_tpu_torch import alma
    from bhnerf_tpu_torch import config as config_lib
    from bhnerf_tpu_torch import units

    cfg = config_lib.RunConfig.from_yaml(cfg_path)
    cfg.preprocess.data_path = csv_path
    opt_cfg = cfg.optimization
    target, t_frames = alma.preprocess_data(
        **dataclasses.asdict(cfg.preprocess))
    split = units.Quantity(cfg.preprocess.t_start, 'hr') + units.Quantity(
        opt_cfg.train_split, 'min')
    t_vals = np.asarray(units.Quantity(t_frames, 'hr').value)
    train_idx = t_vals <= split.to('hr').value
    model = cfg.model
    model_params = dict(model.asdict(), **(model_overrides or {}))
    rt_raw = alma.get_raytracing_args(
        np.deg2rad(inc), model.spin, model_params,
        rot_angle=np.deg2rad(cfg.preprocess.de_rot_angle + 20.0),
        num_subpixel_rays=model.num_subrays, device=device)
    sigma = np.asarray(opt_cfg.sigma)
    chi2 = {}
    for name, idx in (('chi2_train', train_idx), ('chi2_val', ~train_idx)):
        chi2[name] = float(alma.chi2_lightcurves(
            rt_raw, run_dir, units.Quantity(t_vals[idx], 'hr'),
            target[idx], sigma=sigma, batchsize=20))
    return dict(chi2, raytracing_args=rt_raw, t_train=t_vals[train_idx],
                tracer=alma.trace_sizes(model_params))


def card():
    """The card's name and power limit as nvidia-smi gives them, or None
    on the host."""
    if os.environ.get('DRIVE_CPU'):
        return None
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def drive(num_iters=50000, work=None, ngeo=None, n_fine=None, log=print):
    """The whole drive: the synthetic lightcurve, leg 1, leg 2 and the
    evaluation, in `work` (a new temporary directory when None). Returns
    (the result line as a dict, the evaluation of `evaluate`)."""
    import torch
    import yaml

    from bhnerf_tpu_torch.scripts import fit_alma_lp_apr11_sgra_flare as fit

    device = 'cpu' if os.environ.get('DRIVE_CPU') else 'cuda'
    if device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device; set DRIVE_CPU=1 for the host')
    work = work or tempfile.mkdtemp(prefix='alma_prod_')
    os.makedirs(work, exist_ok=True)
    csv_path = os.path.join(work, 'apr11_synth.csv')
    make_synthetic_csv(csv_path)
    cfg = production_config(num_iters, work)
    cfg_path = os.path.join(work, 'config.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(cfg, f)

    run_dir = os.path.join(
        cfg['optimization']['checkpoint_dir'],
        fit.RUN_NAME.format(float(INCLINATION),
                            cfg['optimization']['hparams']['seed']))
    save_period = int(cfg['optimization']['save_period'])
    overrides = {k: v for k, v in (('ngeo', ngeo), ('n_fine', n_fine)) if v}
    # prepend the checkout to PYTHONPATH, never replace it
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get('PYTHONPATH', '')) if p))
    fit_cmd = [sys.executable, '-m', FIT_MODULE, str(INCLINATION),
               '--data_path', csv_path, '--config_path', cfg_path,
               '--writer', 'memory']
    for key, value in overrides.items():
        fit_cmd += [f'--{key}', str(value)]

    t0 = time.time()
    stop_step, leg1, leg2 = run_legs(fit_cmd, env, run_dir, save_period,
                                     num_iters, work, log)
    before = fit.launch_counts()
    t_eval = time.time()
    evaluation = evaluate(cfg_path, csv_path, run_dir, INCLINATION, device,
                          overrides)
    if device == 'cuda':
        torch.cuda.synchronize()
    after = fit.launch_counts()
    wall = time.time() - t0
    result = {
        'metric': 'alma_production', 'num_iters': num_iters,
        'ensemble': int(cfg['model']['num_subrays']),
        'batchsize': int(cfg['optimization']['batchsize']),
        'wall_s': round(wall, 1), 'interrupt_step': stop_step,
        'chi2_train': round(evaluation['chi2_train'], 4),
        'chi2_val': round(evaluation['chi2_val'], 4),
        'steps_per_sec_effective': round(num_iters / wall, 1),
        'ok': bool(np.isfinite(evaluation['chi2_train'])
                   and np.isfinite(evaluation['chi2_val'])),
        'card': card(), 'torch': torch.__version__,
        'cuda': torch.version.cuda, 'evaluate_s': round(
            time.time() - t_eval, 1),
        'launches': {'leg1': leg1, 'leg2': leg2,
                     'evaluate': {k: after[k] - before[k] for k in after}},
        'tracer': evaluation['tracer'],
    }
    return result, evaluation


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--num-iters', type=int, default=50000)
    ap.add_argument('--ngeo', type=int, help='samples a ray (default: '
                                             'alma.TRACE_DEFAULTS)')
    ap.add_argument('--n_fine', type=int, help='fine steps of the tracer '
                                               '(default: alma.TRACE_DEFAULTS)')
    ap.add_argument('--work', help='directory of the run (default: a new '
                                   'temporary directory)')
    args = ap.parse_args(argv)
    result, _ = drive(args.num_iters, args.work, args.ngeo, args.n_fine)
    print(json.dumps(result), flush=True)
    return 0 if result['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
