"""Drive: the port's multi-GPU support at full width, one process a rank.

Each rank runs, from the JSON configuration `--config` (written by
`write_config`), the Tutorial-3 image fit and the ALMA polarized-
lightcurve fit on (data, ray) meshes of torch.distributed ranks:

  trace        the Tutorial-3 screen and the ALMA ensemble's screens
               traced on the device, sharded over every rank
               (trace_geodesics(backend='device', mesh=...));
  step         for each mesh of `meshes`: one gradient step of the
               Tutorial-3 'full' loss on a fixed frame batch from seeded
               parameters: the images of a test step, the global loss,
               the summed gradients and the collectives of each;
  chunks       for each mesh: `chunk_steps` steps of Optimizer.run in
               chunks of `chunk` (every step's loss, the step ms);
  alma         one 'lc' step with 3-Stokes weights under mesh ALMA_MESH;
  checkpoints  rank 0 alone writes, every rank restores the same step,
               rank-local directories that disagree raise;
  nccl         (one rank) an all-reduce and a broadcast of the gradient
               vector on the card.

Each rank writes <work>/rank_<r>.json (launch counts of the three
kernels, collective census, step ms, checkpoint record) and
<work>/rank_<r>.npz (images, losses, gradients, rank 0's trace tables);
the caller holds them against one process (`one_process`). On N cards,
one rank each over NCCL:

    torchrun --nproc_per_node=N -m bhnerf_tpu_torch.scripts.drive_multigpu \\
        --config <work>/config.json

Several ranks on one card need gloo (NCCL refuses two ranks on one
device): pass --backend gloo --device cuda:0, as chip_smoke.py does.
DRIVE_CPU=1 runs on the host over gloo (the kernels' plain versions).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from bhnerf_tpu_torch import alma, constants, units
from bhnerf_tpu_torch.geodesics import (Geodesics, subpixel_jittered_axes,
                                        trace_geodesics)
from bhnerf_tpu_torch.geodesics import integrator
from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.ops import fused
from bhnerf_tpu_torch.parallel import mesh as mesh_lib
from bhnerf_tpu_torch.train import state as state_lib
from bhnerf_tpu_torch.train.optimizer import LogFn, Optimizer, TrainStep
from bhnerf_tpu_torch.train.state import TrainState, make_optimizer
from bhnerf_tpu_torch.train.step import (compact_raytracing_args,
                                         raytracing_args)


def write_config(work, t3_geos, alma_geos, t3, alma_cfg, trace, meshes,
                 chunk_steps, chunk):
    """Write the drive's inputs under `work`: the Tutorial-3 table and one
    ALMA table (Geodesics.save, so that no rank traces on the host), the
    trace screens, and config.json. t3: predictor, fov, nt, batch, seed
    and lr of the Tutorial-3 fit; alma_cfg: model block, predictor, rot
    angle, sigma, nt and seed of the ALMA fit; trace: the keywords of the
    two traces and their screens (alpha, beta arrays)."""
    os.makedirs(work, exist_ok=True)
    t3_geos.save(os.path.join(work, 't3.npz'))
    alma_geos.save(os.path.join(work, 'alma.npz'))
    screens = {f'{k}_{ab}': trace[k][ab] for k in ('t3', 'alma')
               for ab in ('alpha', 'beta')}
    np.savez(os.path.join(work, 'screens.npz'), **screens)
    cfg = dict(work=str(work), t3=t3, alma=alma_cfg,
               trace={k: {kk: vv for kk, vv in v.items()
                          if kk not in ('alpha', 'beta')}
                      for k, v in trace.items()},
               meshes=list(meshes), chunk_steps=chunk_steps, chunk=chunk)
    path = os.path.join(work, 'config.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    return path


def mesh_shape(name):
    return tuple(int(s) for s in name.split('x'))


def t3_constants(cfg, geos, device):
    """The Tutorial-3 fit's ray constants, predictor and frame times (hr):
    (rt, predictor, t_frames)."""
    c = cfg['t3']
    gm_hr = constants.GM_c3(constants.sgra_mass).to('hr').value
    t_frames = np.linspace(0.0, c['span_M'] * gm_hr, c['nt']).astype(
        np.float32)
    rt = raytracing_args(geos, geos.keplerian_omega(),
                         -float(geos.r_o + c['fov'] / 4),
                         units.Quantity(t_frames[0], 'hr'), device=device)
    return rt, NeRFPredictor(**c['predictor']), t_frames


def t3_problem(cfg, geos, device, mesh=None):
    """The Tutorial-3 'full' image fit: ray constants compacted (in the
    sample-parallel layout over `mesh`'s 'ray' axis), a seeded target
    image for every frame, and its TrainStep (frames split over 'data')."""
    c = cfg['t3']
    rt, predictor, t_frames = t3_constants(cfg, geos, device)
    crt = compact_raytracing_args(rt, predictor, mesh=mesh)
    npix = geos.r.shape[0]
    rng = np.random.default_rng(c['seed'])
    target = np.repeat(0.02 * rng.random((1, npix, geos.r.shape[1]),
                                         dtype=np.float32), c['nt'], axis=0)
    ts = TrainStep.image(units.Quantity(t_frames, 'hr'), target, predictor,
                         dtype='full', mesh=mesh, fused=True, device=device)
    return dict(predictor=predictor, crt=crt, ts=ts, batch=c['batch'],
                seed=c['seed'], lr=c['lr'])


def alma_constants(cfg, geos, device):
    """The ALMA fit's ray constants on one table (the host physics of
    alma.get_raytracing_args: Stokes I, Q, U), its predictor (a learned
    injection time, as the fit has) and frame times (hr): (rt,
    predictor, t_frames)."""
    c = cfg['alma']
    model = c['model']
    geos, Omega, J = alma._model_physics(geos, model, c['rot_angle'])
    t_frames = (model['t_start_obs'] + np.linspace(0.0, 103.0 / 60.0,
                                                   c['nt'])).astype(
        np.float32)
    rt = raytracing_args(geos, Omega, -float(geos.r_o + model['fov_M'] / 4),
                         units.Quantity(model['t_start_obs'], 'hr'), J,
                         device=device)
    rmax = model['fov_M'] / 2
    predictor = NeRFPredictor(
        scale=rmax, rmin=float(constants.isco_pro(model['spin'])), rmax=rmax,
        z_width=model['z_width'], **c['predictor'])
    return rt, predictor, t_frames


def alma_problem(cfg, geos, device, mesh=None):
    """The ALMA 'lc' fit on one table: alma_constants compacted in the
    'gather' layout, a seeded lightcurve target with the fit's sigmas, and
    its TrainStep."""
    c = cfg['alma']
    rt, predictor, t_frames = alma_constants(cfg, geos, device)
    crt = compact_raytracing_args(rt, predictor, mesh=mesh, layout='gather')
    rng = np.random.default_rng(c['seed'])
    target = rng.random((c['nt'], 3)) * np.asarray([1.0, 0.1, 0.1])
    ts = TrainStep.image(units.Quantity(t_frames, 'hr'), target, predictor,
                         sigma=np.asarray(c['sigma']), dtype='lc', mesh=mesh,
                         fused=True, device=device)
    return dict(predictor=predictor, crt=crt, ts=ts, batch=cfg['t3']['batch'],
                seed=c['seed'], lr=cfg['t3']['lr'])


def _params(problem, device):
    return problem['predictor'].init_params(
        generator=torch.Generator().manual_seed(problem['seed']),
        device=device)


def one_step(problem, device, mesh=None):
    """Images of a test step on frames 0..batch-1, then one gradient step
    on them from seeded parameters: (images, loss, gradients by parameter
    name, census of the forward, census of the step, step ms). The step
    ms is the median of five more steps."""
    ts, crt = problem['ts'], problem['crt']
    state = TrainState.create(_params(problem, device),
                              make_optimizer(10, lr_init=problem['lr']))
    batch = np.arange(problem['batch'])
    census, images = [], None
    for update in (False, True):
        if mesh is not None:
            mesh.census.reset()
        loss, state, out = ts(state, crt, batch, update_state=update)
        census.append({} if mesh is None else mesh.census.as_dict())
        if images is None:
            images = out.cpu().numpy()
    grads = {n: p.grad.cpu().numpy().copy()
             for n, p in state.params.named_parameters()}
    times = []
    for _ in range(5):
        _sync(device)
        t0 = time.perf_counter()
        ts(state, crt, batch)
        _sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
    return images, float(loss), grads, census[0], census[1], \
        float(np.median(times))


def chunked(problem, steps, chunk, device):
    """`steps` steps of Optimizer.run in chunks of `chunk` (lr
    problem['lr'] -> a tenth): (every step's loss, ms a step)."""
    losses = []
    opt = Optimizer({'num_iters': steps, 'lr_init': problem['lr'],
                     'lr_final': problem['lr'] / 10,
                     'seed': problem['seed']}, problem['predictor'],
                    problem['crt'], device=device)
    _sync(device)
    t0 = time.perf_counter()
    opt.run(problem['batch'], problem['ts'], problem['crt'], verbose=False,
            scan_chunk=chunk,
            log_fns=[LogFn(lambda o: losses.append(float(o.loss)))])
    _sync(device)
    return np.asarray(losses), 1e3 * (time.perf_counter() - t0) / steps


def traces(cfg, screens, device, mesh=None):
    """The Tutorial-3 and ALMA device traces (each one launch a rank):
    {'t3': Geodesics, 'alma': Geodesics of the stacked screens}."""
    out = {}
    for k in ('t3', 'alma'):
        out[k] = trace_geodesics(screens[f'{k}_alpha'], screens[f'{k}_beta'],
                                 backend='device', device=device, mesh=mesh,
                                 **cfg['trace'][k])
    return out


def alma_screens(model, num_variants, seed):
    """The stacked sub-pixel screens of an ALMA ensemble, drawn as
    alma._trace_subpixel_ensemble draws them."""
    rng = np.random.default_rng(seed)
    half = model['fov_M'] / 2
    alphas, betas = [], []
    for _ in range(num_variants):
        a1, b1 = subpixel_jittered_axes((-half, half), (-half, half),
                                        model['num_alpha'],
                                        model['num_beta'], rng)
        a, b = np.meshgrid(a1, b1, indexing='ij')
        alphas.append(a)
        betas.append(b)
    return np.stack(alphas), np.stack(betas)


# the sample-parallel mesh of the ALMA step
ALMA_MESH = '1x2'
TABLE_FIELDS = ('r', 'theta', 'phi', 't', 'pm_r', 'pm_th', 'tau_final')


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _checkpoints(cfg, problem, device, rank):
    """Rank 0 alone writes (counted here), every rank restores the same
    step, and rank-local directories that disagree raise."""
    work = cfg['work']
    writes = []
    write = state_lib._write_checkpoint

    def counted(*args):
        writes.append(int(args[2]))
        return write(*args)

    state_lib._write_checkpoint = counted
    try:
        shared = os.path.join(work, 'ckpt')
        opt = Optimizer({'num_iters': 4, 'lr_init': problem['lr'],
                         'seed': problem['seed']}, problem['predictor'],
                        problem['crt'], save_period=2, checkpoint_dir=shared,
                        keep=1, device=device)
        opt.run(problem['batch'], problem['ts'], problem['crt'],
                verbose=False)
    finally:
        state_lib._write_checkpoint = write
    again = Optimizer({'num_iters': 4, 'seed': problem['seed']},
                      problem['predictor'], problem['crt'],
                      checkpoint_dir=shared, device=device)
    record = dict(writes=writes, listing=sorted(os.listdir(shared)),
                  restored_step=again.state.step, disagree_error=None)
    local = os.path.join(work, f'local_{rank}')
    os.makedirs(os.path.join(local, 'checkpoint_2') if rank == 0 else local,
                exist_ok=True)
    try:
        state_lib.restore_checkpoint(local, again.state)
    except RuntimeError as e:
        record['disagree_error'] = str(e)
    return record


def _launches():
    return {'render_fwd': fused.render_fwd.launches,
            'render_bwd': fused.render_bwd.launches,
            'trace_rays': integrator.trace_rays.launches}


def run_rank(cfg, device, nccl_probe=False):
    """Everything the configuration asks of this rank; returns (record,
    arrays) for rank_<r>.json and rank_<r>.npz."""
    rank = mesh_lib.process_rank()
    record, arrays = {'rank': rank, 'device': str(device), 'census': {},
                      'step_ms': {}}, {}
    t3_geos = Geodesics.load(os.path.join(cfg['work'], 't3.npz'))
    alma_geos = Geodesics.load(os.path.join(cfg['work'], 'alma.npz'))
    screens = dict(np.load(os.path.join(cfg['work'], 'screens.npz')))
    fused.render_fwd.launches = fused.render_bwd.launches = 0
    integrator.trace_rays.launches = 0
    t_start = time.perf_counter()
    if nccl_probe:
        mesh = mesh_lib.create_mesh((1, 1), device=device)
        images, loss, grads, _, _, ms = one_step(
            t3_problem(cfg, t3_geos, device, mesh), device, mesh)
        flat = torch.cat([torch.as_tensor(g).reshape(-1)
                          for g in grads.values()]).to(device)
        summed = flat.clone()
        torch.distributed.all_reduce(summed)
        sent = flat.clone()
        torch.distributed.broadcast(sent, src=0)
        record.update(nccl_backend=torch.distributed.get_backend(),
                      nccl_identity=bool(torch.equal(summed, flat)
                                         and torch.equal(sent, flat)),
                      nccl_elements=int(flat.numel()), loss=loss,
                      step_ms={'1x1': ms})
        arrays['nccl/images'] = images
    else:
        mesh = mesh_lib.create_mesh(device=device)
        t0 = time.perf_counter()
        tables = traces(cfg, screens, device, mesh)
        record['trace_s'] = time.perf_counter() - t0
        record['census']['trace'] = mesh.census.as_dict()
        for k, g in tables.items():
            for f in TABLE_FIELDS:
                a = np.asarray(getattr(g, f))
                record.setdefault('trace_digest', {})[f'{k}/{f}'] = \
                    float(np.nansum(np.abs(a.astype(np.float64))))
                if rank == 0:
                    arrays[f'trace/{k}/{f}'] = a
        for name in cfg['meshes']:
            mesh = mesh_lib.create_mesh(mesh_shape(name), device=device)
            problem = t3_problem(cfg, t3_geos, device, mesh)
            record.setdefault('local_n', {})[name] = int(
                problem['crt'].coords.shape[-1])
            images, loss, grads, c_fwd, c_step, ms = one_step(problem,
                                                              device, mesh)
            record['census'][f'{name}/forward'] = c_fwd
            record['census'][f'{name}/step'] = c_step
            record['step_ms'][name] = ms
            arrays[f'{name}/images'] = images
            arrays[f'{name}/loss'] = np.float64(loss)
            arrays.update({f'{name}/grad/{k}': v for k, v in grads.items()})
            mesh.census.reset()
            losses, ms = chunked(problem, cfg['chunk_steps'], cfg['chunk'],
                                 device)
            record['census'][f'{name}/chunks'] = mesh.census.as_dict()
            record['step_ms'][f'{name}/chunks'] = ms
            arrays[f'{name}/chunk_losses'] = losses
        name = ALMA_MESH
        mesh = mesh_lib.create_mesh(mesh_shape(name), device=device)
        images, loss, grads, c_fwd, c_step, ms = one_step(
            alma_problem(cfg, alma_geos, device, mesh), device, mesh)
        record['census'][f'alma {name}/forward'] = c_fwd
        record['census'][f'alma {name}/step'] = c_step
        record['step_ms'][f'alma {name}'] = ms
        arrays['alma/loss'] = np.float64(loss)
        arrays.update({f'alma/grad/{k}': v for k, v in grads.items()})
        record['checkpoints'] = _checkpoints(
            cfg, t3_problem(cfg, t3_geos, device, mesh), device, rank)
    _sync(device)
    record['launches'] = _launches()
    record['seconds'] = time.perf_counter() - t_start
    return record, arrays


def one_process(cfg, device):
    """The one-process results that the ranks are held against, on the
    same inputs: the traces, the Tutorial-3 step and chunked run, and the
    ALMA step (each as run_rank gives it, with no mesh)."""
    t3_geos = Geodesics.load(os.path.join(cfg['work'], 't3.npz'))
    alma_geos = Geodesics.load(os.path.join(cfg['work'], 'alma.npz'))
    screens = dict(np.load(os.path.join(cfg['work'], 'screens.npz')))
    t0 = time.perf_counter()
    tables = traces(cfg, screens, device)
    out = {'trace_s': time.perf_counter() - t0, 'tables': tables}
    problem = t3_problem(cfg, t3_geos, device)
    out['local_n'] = int(problem['crt'].coords.shape[-1])
    out['step'] = one_step(problem, device)
    out['chunks'] = chunked(problem, cfg['chunk_steps'], cfg['chunk'],
                            device)
    out['alma'] = one_step(alma_problem(cfg, alma_geos, device), device)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', required=True)
    parser.add_argument('--backend', default=None,
                        help="'nccl' (the default on a card) or 'gloo'")
    parser.add_argument('--device', default=None,
                        help='this rank\'s device (default cuda:<LOCAL_RANK>)')
    parser.add_argument('--nccl-probe', action='store_true',
                        help='one rank: a step and NCCL collectives only')
    args = parser.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    device = 'cpu' if os.environ.get('DRIVE_CPU') else args.device
    if not mesh_lib.initialize_distributed(backend=args.backend,
                                           device=device):
        raise SystemExit('no cluster environment: run under torchrun')
    device = torch.device(device) if device is not None else torch.device(
        'cuda', torch.cuda.current_device())
    record, arrays = run_rank(cfg, device, args.nccl_probe)
    record['backend'] = torch.distributed.get_backend()
    rank = record['rank']
    np.savez(os.path.join(cfg['work'], f'rank_{rank}.npz'), **arrays)
    with open(os.path.join(cfg['work'], f'rank_{rank}.json'), 'w') as f:
        json.dump(record, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f'# rank {rank} done in {record["seconds"]:.1f} s', flush=True)


if __name__ == '__main__':
    main()
