"""End-to-end recovery benchmark: the README / BASELINE.md north star.

PyTorch counterpart of the repository's `bench_recovery.py`, on one CUDA
card:

    python -m bhnerf_tpu_torch.bench_recovery [--small] [--eht]
        [--npix N] [--operator dense|factored] [--num-iters N]

Default mode runs the Tutorial-3 image-plane workload (64x64 rays x
ngeo=100, 64 frames, 1000 iterations, domain compaction + the fused CUDA
kernels); `--eht` recovers the Tutorial-4 hotspot FROM AN ngEHT
OBSERVATION (thermal-noise visibility synthesis -> complex-visibility
chi^2 loss, 5000 iterations; `--npix 128` takes the factored operator).
Each prints ONE JSON line on stdout:

  {"metric": ..., "wall_s": ..., "psnr_3d": ..., "lc_err_pct": ..., ...}

wall_s is training time only (geodesic precompute and the first chunks
excluded); psnr_3d is the recovered-vs-true 3D volume PSNR on a 64^3
grid; lc_err_pct is the mean absolute lightcurve error of the recovered
movie in percent of the mean true flux. Results are also written into
RECOVERY.json beside this module (mode-keyed; never the repository
root's RECOVERY.json, which holds the reference's bars). Beside the
reference's keys the line carries the card's power limit.

Without a CUDA device `main` prints one JSON line whose value is null and
exits 2; it never measures on the CPU unless the caller passes
device='cpu', as the tests do.
"""
import json
import os
import sys
import time
import types

import numpy as np
import torch

from bhnerf_tpu_torch.bench import cached_geos, card_info, mark

RECOVERY_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'RECOVERY.json')


def record(result, path=None):
    """Write the result into RECOVERY.json (RECOVERY_PATH by default),
    keyed by configuration: the npix-128/factored entry must not
    overwrite the npix-64 default one."""
    path = RECOVERY_PATH if path is None else path
    blob = {}
    if os.path.exists(path):
        with open(path) as f:
            blob = json.load(f)
    key = result['metric']
    if result.get('npix') not in (None, 64):
        key += f"_npix{result['npix']}"
    if result.get('operator') not in (None, 'dense'):
        key += f"_{result['operator']}"
    blob[key] = result
    with open(path, 'w') as f:
        json.dump(blob, f, indent=1)


def main(num_iters=1000, small=False, eht=False, npix=None, operator=None,
         device='cuda'):
    """One recovery on `device`; prints and records its JSON line.
    Returns a namespace: `result` (the line's dict) and the run's
    optimizer, train_step, crt, the true movie, the recovered frames and
    the recovered 64^3 volume."""
    if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
        # value null + rc 2: no card must never read as a measured result
        print(json.dumps({
            'metric': 'time_to_recover_eht' if eht else 'time_to_recover',
            'value': None, 'wall_s': None, 'psnr_3d': None,
            'lc_err_pct': None, 'error': 'no CUDA device'}))
        print('# no CUDA device; see error key', file=sys.stderr)
        sys.exit(2)

    from bhnerf_tpu_torch import constants, emission, observation, units
    from bhnerf_tpu_torch import utils
    from bhnerf_tpu_torch.models import NeRFPredictor, sample_3d_grid
    from bhnerf_tpu_torch.train import (Optimizer, TrainStep, TrainState,
                                        raytracing_args, total_movie_loss)
    from bhnerf_tpu_torch.train.step import (compact_raytracing_args,
                                             make_scan_step)
    from bhnerf_tpu_torch.tutorials import array_path

    device = torch.device(device)
    spin, inc = 0.2, np.deg2rad(60.0)
    fov_M = 16.0
    num = npix if npix else (16 if small else 64)
    # the dense per-frame DFT operator stops fitting past npix=64
    # (~320 MB at ngEHT nvis); the factored separable form is the
    # production default there (chisq-equal, npix-fold smaller)
    if operator is None:
        operator = 'factored' if num > 64 else 'dense'
    ngeo = 32 if small else 100
    nt = 16 if small else 64
    batch = min(6, nt)
    compute_dtype = os.environ.get('BENCH_COMPUTE_DTYPE', 'bfloat16')

    info = card_info(device)
    mark(f'{info["chip"]}, {info["power_limit_w"]} W; geodesics')
    # the reference traces at image_plane_geos' default fine steps
    geos = cached_geos('rec', spin, inc, fov_M, num, ngeo, 8192)
    Omega = geos.keplerian_omega()
    r_isco = float(constants.isco_pro(spin))
    hotspot = emission.generate_hotspot(
        resolution=(64, 64, 64), rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=1.1 * r_isco, std=0.7, r_isco=r_isco, fov=fov_M)
    # --eht frames sit on the ngEHT scan window [4, 15.5] UT (reference
    # Tutorial4); image mode keeps the 1-hour Tutorial-3 movie
    t_frames = units.Quantity(
        np.linspace(4.0, 15.5, nt).astype(np.float32) if eht
        else np.linspace(0.0, 1.0, nt), 'hr')
    t_injection = -float(geos.r_o + fov_M / 4)
    mark('rendering ground-truth movie')
    movie = emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection,
        device=device).cpu().numpy()

    predictor = NeRFPredictor(scale=fov_M / 2, rmin=0.0, rmax=fov_M / 2,
                              z_width=2.0, compute_dtype=compute_dtype)
    rt = raytracing_args(geos, Omega, t_injection, t_frames[0],
                         device=device)
    crt = compact_raytracing_args(rt, predictor)
    if eht:
        mark('synthesizing ngEHT observation')
        array = observation.load_txt(array_path('ngEHT.txt'))
        obs_empty = observation.empty_eht_obs(array, nt=nt, tint=30.0)
        fov_rad = float(fov_M * constants.GM_c2(constants.sgra_mass).value
                        / constants.sgra_distance.to('m').value)
        obs = observation.observe_same(movie, np.asarray(t_frames.value),
                                       fov_rad / num, obs_empty,
                                       thermal_noise=True, seed=0)
        train_step = TrainStep.eht(t_frames, obs, fov_rad, num, predictor,
                                   dtype='vis', fused=True,
                                   operator=operator, device=device)
    else:
        train_step = TrainStep.image(t_frames, movie, predictor,
                                     dtype='full', fused=True, device=device)
    optimizer = Optimizer({'num_iters': num_iters, 'lr_init': 1e-3,
                           'lr_final': 1e-5}, predictor, crt,
                          checkpoint_dir='', device=device)

    # the first chunk of each length, on a throwaway state outside the
    # timed window (the reference compiles its scans there)
    mark('warm-up chunks')
    chunk = int(os.environ.get('BENCH_SCAN_CHUNK', 500))
    dev_args = train_step.args[0].device_args
    state_warm = TrainState.create(
        predictor.init_params(generator=torch.Generator().manual_seed(9),
                              device=device), optimizer.state.tx)
    gen = torch.Generator().manual_seed(0)
    for length in sorted({min(chunk, num_iters), num_iters % chunk} - {0}):
        scan_fn = make_scan_step(batchsize=batch, chunk=length,
                                 **train_step.scan_meta)
        idx = torch.stack([train_step.args[0].sample(batch, gen)
                           for _ in range(length)]).to(device)
        state_warm, losses = scan_fn(state_warm, *dev_args, idx,
                                     [0] * length, crt, 1.0)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    del state_warm

    mark('training')
    t0 = time.perf_counter()
    optimizer.run(batchsize=batch, train_step=train_step,
                  raytracing_args=crt, verbose=False, scan_chunk=chunk)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0

    mark(f'training done in {wall_s:.1f}s; evaluating')
    vol = sample_3d_grid(predictor, optimizer.params, fov=fov_M,
                         resolution=64)
    psnr_3d = float(utils.psnr(np.asarray(hotspot.data), vol))
    _, frames = total_movie_loss(min(8, nt), optimizer.state, train_step,
                                 crt, return_frames=True)
    lc_rec = np.asarray(frames).sum(axis=(-1, -2))
    lc_true = movie.sum(axis=(-1, -2))
    lc_err_pct = float(100.0 * np.mean(np.abs(lc_rec - lc_true))
                       / np.mean(lc_true))

    result = {
        'metric': 'time_to_recover_eht' if eht else 'time_to_recover',
        'wall_s': round(wall_s, 2),
        'psnr_3d': round(psnr_3d, 2),
        'lc_err_pct': round(lc_err_pct, 4),
        'num_iters': num_iters,
        'npix': num,
        'compute_dtype': compute_dtype,
        'chip': info['chip'],
    }
    if eht:
        result['operator'] = operator
    result['power_limit_w'] = info['power_limit_w']
    record(result)
    print(json.dumps(result), flush=True)
    return types.SimpleNamespace(
        result=result, optimizer=optimizer, train_step=train_step, crt=crt,
        movie=movie, frames=frames, volume=vol)


if __name__ == '__main__':
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument('--num-iters', type=int, default=None,
                   help='default: 1000 (image mode) / 5000 (--eht, the '
                        'reference Tutorial-4 iteration count)')
    p.add_argument('--small', action='store_true')
    p.add_argument('--eht', action='store_true',
                   help='recover from an ngEHT visibility observation '
                        '(the BASELINE.md north-star problem)')
    p.add_argument('--npix', type=int, default=None,
                   help='image/ray grid size (default 64; 128 = the '
                        'production ALMA/EHT image size, auto-selects '
                        'the factored measurement operator)')
    p.add_argument('--operator', default=None,
                   choices=['dense', 'factored'],
                   help='EHT measurement operator (default: dense up '
                        'to npix=64, factored past it)')
    args = p.parse_args()
    n = args.num_iters if args.num_iters else (5000 if args.eht else 1000)
    main(n, args.small, eht=args.eht, npix=args.npix,
         operator=args.operator)
