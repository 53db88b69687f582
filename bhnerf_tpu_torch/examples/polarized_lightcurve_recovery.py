"""Recover a 3D emission volume from Q/U lightcurves alone.

PyTorch counterpart of examples/polarized_lightcurve_recovery.py (the
reference's "Synthetic lightcurves 1 - Recovery idealized" workflow):
render the I, Q and U lightcurves of a hotspot at 60 degrees on the
card, fit the NeRF to the Q and U lightcurves alone at the true
inclination through domain compaction and the fused kernels, and report
the data fit and the recovered volume's correlation and PSNR against the
hotspot. Lightcurve-only tomography is strongly ill-posed (1D data ->
3D volume); this is the single-seed, few-thousand-iteration core of the
50,000-iteration sweeps of scripts/fit_synthetic_lp_flares.py.

    python -m bhnerf_tpu_torch.examples.polarized_lightcurve_recovery \\
        [--small]

The full configuration traces 64x64 rays and fits 3000 per-step
iterations; --small 16x16 rays and 200. Frame batches come from an
explicit torch.Generator of seed 0 and the initial weights from one of
seed 1.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

CONFIGS = {
    'small': dict(num=16, nt=16, iters=200, res=32),
    'full': dict(num=64, nt=64, iters=3000, res=64),
}
INC_TRUE = np.deg2rad(60.0)
FOV = 30.0
MODEL = {
    'spin': 0.0, 'fov_M': FOV, 'z_width': 3.0, 'rmin': 'ISCO',
    'Q_frac': 0.85, 'b_consts': {'arad': 0, 'avert': 1, 'ator': 0},
    'Omega_dir': 'cw', 'Omega_frac': 1.0, 't_start_obs': 9.34,
}
PREDICTOR = dict(scale=15.0, rmin=6.0, rmax=15.0, z_width=3.0)
BATCH = 6
SIGMA = 0.01


def hotspot_lightcurves(num, nt, res, device='cuda'):
    """The hotspot's I, Q and U lightcurves at 60 degrees (reference
    :34-47): the ALMA image-plane model at num x num rays, the hotspot on
    a res^3 grid, the movie of nt frames over 9.34-10.4 h rendered on
    `device`. Returns a dict of geos, Omega, J, hotspot, t_frames,
    t_injection and lc (nt, 3) numpy."""
    from bhnerf_tpu_torch import alma, emission, units

    model = dict(MODEL, num_alpha=num, num_beta=num)
    geos, Omega, J = alma.image_plane_model(INC_TRUE, 0.0, model,
                                            device=device)
    hotspot = emission.generate_hotspot((res,) * 3, [0, 0, 1], 0.0, 8.0,
                                        1.0, 6.0, FOV)
    t_frames = units.Quantity(np.linspace(9.34, 10.4, nt), 'hr')
    t_injection = -float(geos.r_o + 7.5)
    movie = emission.image_plane_dynamics(
        hotspot, geos, Omega, t_frames, t_injection, J=J,
        t_start_obs=t_frames[0], device=device).cpu().numpy()
    return dict(geos=geos, Omega=Omega, J=J, hotspot=hotspot,
                t_frames=t_frames, t_injection=t_injection,
                lc=movie.sum(axis=(-1, -2)))


def fit_qu(data, iters, device='cuda', params=None, indices=None):
    """Fit the NeRF to data['lc']'s Q and U rows (reference :49-66): the
    ray constants with J's Q and U rows, compacted, and 'lc' steps through
    the fused kernels, lr 1e-3 -> 1e-5 over `iters`. params: initial
    NeRFParams (he-uniform from seed 1 when None); indices: the frame
    batch of every step (drawn from a generator of seed 0 when None).
    Returns a dict of predictor, state and the losses (numpy)."""
    import torch

    from bhnerf_tpu_torch.models.fields import NeRFPredictor
    from bhnerf_tpu_torch.train import (TrainState, TrainStep,
                                        compact_raytracing_args,
                                        make_optimizer, raytracing_args)

    predictor = NeRFPredictor(**PREDICTOR)
    # fit Q and U only (Stokes rows 1:3), as the synthetic flares script
    step = TrainStep.image(data['t_frames'], data['lc'][:, 1:3], predictor,
                           sigma=SIGMA, dtype='lc', fused=True,
                           device=device)
    rt = raytracing_args(data['geos'], data['Omega'], data['t_injection'],
                         data['t_frames'][0], J=data['J'][1:3],
                         device=device)
    crt = compact_raytracing_args(rt, predictor)
    if params is None:
        params = predictor.init_params(
            generator=torch.Generator().manual_seed(1), device=device)
    state = TrainState.create(params, make_optimizer(iters, lr_init=1e-3,
                                                     lr_final=1e-5))
    generator = torch.Generator().manual_seed(0)
    losses = []
    for i in range(iters):
        inds = (step.args[0].sample(BATCH, generator) if indices is None
                else indices[i])
        loss, state, _ = step(state, crt, inds)
        losses.append(loss)
    return dict(predictor=predictor, state=state,
                losses=torch.stack(losses).cpu().numpy())


def main(small=False, device='cuda'):
    """The whole example; returns a dict of corr, psnr, the final loss and
    the fit's seconds."""
    from bhnerf_tpu_torch import utils
    from bhnerf_tpu_torch.models.fields import sample_3d_grid

    cfg = CONFIGS['small' if small else 'full']
    data = hotspot_lightcurves(cfg['num'], cfg['nt'], cfg['res'], device)
    print('lc ranges:', data['lc'].min(0), data['lc'].max(0), flush=True)
    t0 = time.perf_counter()
    fit = fit_qu(data, cfg['iters'], device)
    fit_s = time.perf_counter() - t0
    final = float(fit['losses'][-1])
    print(f'{cfg["iters"]} iters in {fit_s:.1f}s, final loss {final:.1f}',
          flush=True)
    vol = sample_3d_grid(fit['predictor'], fit['state'].params, fov=FOV,
                         resolution=cfg['res'])
    truth = data['hotspot'].data.numpy()
    corr = float(np.corrcoef(vol.ravel(), truth.ravel())[0, 1])
    psnr = float(utils.psnr(truth, vol))
    print(f'3D recovery from Q/U lightcurves alone: corr {corr:.3f}, PSNR '
          f'{psnr:.1f} dB', flush=True)
    return dict(corr=corr, psnr=psnr, final_loss=final, fit_s=fit_s,
                iters=cfg['iters'])


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--small', action='store_true')
    args = p.parse_args()
    main(args.small)
