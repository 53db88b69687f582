"""One rank of the port's multi-process tests (tests/test_torch_parallel.py
and tests/test_torch_parallel_ranks.py), on the CPU over gloo.

Run as: python _torch_parallel_worker.py <job> <rank> <world> <port> <dir>

job 'compute' <meshes>: reads <dir>/inputs.npz (ray constants, parameters
in the JAX package's layout, targets and EHT data, written by the test
from a numpy seed) and, for each mesh shape of the comma-separated list
(e.g. 1x2,2x1), runs the cases of CASES under it through the port's entry
points: the test step's images, one gradient step's loss and gradients
(read from .grad after the step, before which Adam has used them), the
collective census of each, and for the 'chunk' case an Optimizer.run in
chunks with its frame draws. Also the sharded device trace on the plain
tracer. Writes <dir>/out_<rank>.npz.

job 'integration': rank-0 checkpoint writes, the step agreement of a
restore and its failure on rank-local directories, the seed check, and a
SIGTERM from the test to every rank that checkpoints and resumes
(<dir>/ready_<rank> and <dir>/go are the handshake).

Prints 'WORKER_OK <rank>' on success.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bhnerf_tpu_torch import units  # noqa: E402
from bhnerf_tpu_torch.geodesics import trace_geodesics  # noqa: E402
from bhnerf_tpu_torch.models.fields import (NeRFPredictor,  # noqa: E402
                                            params_to_numpy)
from bhnerf_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from bhnerf_tpu_torch.train import state as state_lib  # noqa: E402
from bhnerf_tpu_torch.train.optimizer import (LogFn, Optimizer,  # noqa: E402
                                              TrainStep)
from bhnerf_tpu_torch.train.state import TrainState, make_optimizer  # noqa
from bhnerf_tpu_torch.train.step import (RayTracingArgs,  # noqa: E402
                                         compact_raytracing_args)

# the reference fixture's predictor (tests/test_parallel.py:21-33)
PRED_KW = dict(scale=8.0, rmin=3.0, rmax=8.0, z_width=2.0, net_depth=2,
               net_width=16)
TV_SCALE = 1.0
CHUNK_STEPS, CHUNK = 20, 5
BATCH = 4
# (case, meshes it runs under); every case runs on its ray constants in
# the sample-parallel layout of the mesh and its frames split over 'data'
CASES = {
    'full': None, 'tv': None, 'inject': None,
    'lc': ('1x2', '2x2'), 'native': ('1x2',),
    'eht_dense': ('1x2',), 'eht_factored': ('1x2',),
    'chunk': ('1x2', '2x1'),
}


def tensor(x):
    return torch.as_tensor(np.array(x, np.float32))


def ray_constants(inp, polarized):
    """The port's RayTracingArgs from the JAX package's arrays, so that
    both packages compact the same float32 inputs."""
    return RayTracingArgs(
        coords=tensor(inp['coords']), Omega=tensor(inp['Omega']),
        J=tensor(inp['J']) if polarized else 1.0, g=tensor(inp['g']),
        dtau=tensor(inp['dtau']), Sigma=tensor(inp['Sigma']),
        t_geos_rel=tensor(inp['t_geos_rel']),
        t_injection=torch.zeros(()), t_start_obs=float(inp['t_start_obs']),
        t_to_M=float(inp['t_to_M']), t_units=units.hr)


def jax_params(inp, prefix='p'):
    """The JAX package's parameter pytree from the flat npz keys."""
    out = {}
    for key in inp.files:
        if key.startswith(prefix + '/'):
            node = out
            *path, leaf = key.split('/')[1:]
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = np.asarray(inp[key])
    return out


def grads_of(params):
    """The gradients, in the JAX package's pytree layout, flattened to
    'dense_i/kernel' keys."""
    out = {}
    for i, layer in enumerate(params.mlp.layers):
        out[f'dense_{i}/kernel'] = layer.weight.grad.numpy().T.copy()
        out[f'dense_{i}/bias'] = layer.bias.grad.numpy().copy()
    if params.t_injection is not None:
        out['t_injection'] = params.t_injection.grad.numpy().copy()
    return out


class EhtData:
    """A duck-typed observation: chisqdata returns the test's arrays."""

    def __init__(self, inp, operator):
        self.arrays = (inp['eht_target'], inp['eht_sigma'],
                       inp[f'eht_A_{operator}'])

    def chisqdata(self, t_frames, dtype, image_fov, image_size, pol='I',
                  **kw):
        return self.arrays


def case_setup(case, mesh, inp):
    """(predictor, params, ray constants, train step) of a case."""
    pred = NeRFPredictor(**PRED_KW, learn_injection=case == 'inject')
    p_np = jax_params(inp)
    if case == 'inject':
        p_np['t_injection'] = np.float32(2.0)
    params = pred.params_from_jax(p_np, device='cpu')
    polarized = case in ('lc', 'native')
    rt = ray_constants(inp, polarized)
    crt = compact_raytracing_args(
        rt, pred, tile=256, mesh=mesh,
        layout='native' if case == 'native' else 'gather')
    t_frames = units.Quantity(inp['t_hr'], 'hr')
    if case.startswith('eht'):
        ts = TrainStep.eht(t_frames, EhtData(inp, case[4:]), 1.0,
                           int(inp['eht_npix']), pred, dtype='vis',
                           mesh=mesh, fused=True,
                           operator=case[4:], device='cpu')
    elif case == 'lc':
        ts = TrainStep.image(t_frames, inp['lc_target'], pred,
                             sigma=inp['lc_sigma'], dtype='lc', mesh=mesh,
                             fused=True, device='cpu')
    else:
        target = inp['target_pol'] if polarized else inp['target']
        ts = TrainStep.image(t_frames, target, pred, dtype='full',
                             mesh=mesh, fused=True, device='cpu',
                             tv_scale=TV_SCALE if case == 'tv' else 0.0)
    return pred, params, crt, ts


def run_case(case, mesh, inp):
    pred, params, crt, ts = case_setup(case, mesh, inp)
    out = {'local_n': np.int64(crt.coords.shape[-1]),
           'n_valid': np.int64(int((crt.t_geos_rel > -1e29).sum()))}
    if case == 'chunk':
        return {**out, **run_chunk(pred, crt, ts, mesh)}
    state = TrainState.create(params, make_optimizer(10, lr_init=1e-3))
    batch = np.arange(BATCH)
    mesh.census.reset()
    loss, _, images = ts(state, crt, batch, update_state=False)
    out['census_forward'] = json.dumps(mesh.census.as_dict())
    out['test_loss'] = float(loss)
    out['images'] = images.numpy()
    mesh.census.reset()
    loss, state, _ = ts(state, crt, batch)
    out['census_step'] = json.dumps(mesh.census.as_dict())
    out['loss'] = float(loss)
    out.update({f'grad/{k}': v for k, v in grads_of(state.params).items()})
    return out


def run_chunk(pred, crt, ts, mesh):
    """Optimizer.run in chunks: the initial params, every step's frame
    draw and the loss at each chunk's end."""
    draws, losses = [], []
    sample = ts.args[0].sample

    def recorded(batchsize, generator=None):
        batch = sample(batchsize, generator)
        draws.append(batch.numpy().copy())
        return batch

    ts.args[0].sample = recorded
    opt = Optimizer({'num_iters': CHUNK_STEPS, 'lr_init': 1e-3, 'seed': 7},
                    pred, crt, device='cpu')
    init = params_to_numpy(opt.params)
    opt.run(BATCH, ts, crt, verbose=False, scan_chunk=CHUNK,
            log_fns=[LogFn(lambda o: losses.append(float(o.loss)),
                           log_period=CHUNK)])
    out = {'draws': np.stack(draws), 'losses': np.asarray(losses)}
    out.update({f'init/{k}/{leaf}': v for k, d in init.items()
                for leaf, v in d.items()})
    return out


def run_trace(inp, mesh):
    """The sharded device trace (plain tracer on the CPU)."""
    kw = json.loads(str(inp['trace_kw']))
    geos = trace_geodesics(inp['trace_alpha'], inp['trace_beta'],
                           backend='device', device='cpu', mesh=mesh, **kw)
    return {f'trace/{f}': np.asarray(getattr(geos, f))
            for f in ('r', 'theta', 'phi', 't', 'tau_final', 'pm_r')}


def run_frames_api(mesh):
    """replicate, shard_frames and make_global_frames on a mesh of every
    rank on 'data'."""
    rank, ndata = mesh.rank, mesh.shape['data']
    frames = np.arange(4 * ndata * 3, dtype=np.float32).reshape(-1, 3)
    mine = mesh_lib.shard_frames({'x': frames}, mesh)['x']
    glob = mesh_lib.make_global_frames([mine], mesh,
                                       num_frames=len(frames))[0]
    out = {'api/shard': mine, 'api/global': glob.numpy()}
    try:
        mesh_lib.make_global_frames([mine[:1 + rank]], mesh)
    except ValueError as e:
        out['api/unequal_error'] = str(e)
    rep = mesh_lib.replicate({'w': torch.full((3,), float(rank)),
                              'a': np.full(2, rank)}, mesh)
    out['api/replicated_w'] = rep['w'].numpy()
    out['api/replicated_a'] = rep['a'].numpy()
    return out


def compute(rank, work, meshes):
    inp = np.load(os.path.join(work, 'inputs.npz'))
    out = {}
    for name in meshes.split(','):
        shape = tuple(int(s) for s in name.split('x'))
        mesh = mesh_lib.create_mesh(shape, device='cpu')
        for case, only in CASES.items():
            if only is None or name in only:
                for k, v in run_case(case, mesh, inp).items():
                    out[f'{name}/{case}/{k}'] = v
    mesh = mesh_lib.create_mesh(device='cpu')
    out.update(run_trace(inp, mesh))
    out.update(run_frames_api(mesh))
    if 'LOCAL_WORLD_SIZE' in os.environ:
        hybrid = mesh_lib.create_hybrid_mesh((1, 2), device='cpu')
        out['hybrid_shape'] = np.asarray(list(hybrid.shape.values()))
        out['hybrid_coords'] = np.asarray(list(hybrid.coords.values()))
    np.savez(os.path.join(work, f'out_{rank}.npz'), **out)


def integration(rank, work):
    inp = np.load(os.path.join(work, 'inputs.npz'))
    mesh = mesh_lib.create_mesh((1, 2), device='cpu')
    pred, _, crt, ts = case_setup('full', mesh, inp)
    shared = os.path.join(work, 'ckpt')
    log = {}

    # the seed check: different seeds on the ranks raise on every rank
    opt = Optimizer({'num_iters': 2, 'seed': 7 + rank}, pred, crt,
                    device='cpu')
    try:
        opt.run(BATCH, ts, crt, verbose=False)
    except RuntimeError as e:
        log['seed_error'] = str(e)

    # rank 0 alone writes (and prunes) the checkpoints
    writes = []
    write = state_lib._write_checkpoint
    state_lib._write_checkpoint = lambda *a: (writes.append(a[2]), write(*a))
    opt = Optimizer({'num_iters': 10, 'lr_init': 1e-3, 'seed': 7}, pred, crt,
                    save_period=5, checkpoint_dir=shared, keep=1,
                    device='cpu')
    opt.run(BATCH, ts, crt, verbose=False, scan_chunk=5)
    log['writes'] = list(writes)
    log['listing'] = sorted(os.listdir(shared))
    log['trained'] = params_to_numpy(opt.params)['dense_0']['kernel'] \
        .tolist()

    # every rank restores the same step
    again = Optimizer({'num_iters': 10, 'seed': 7}, pred, crt,
                      checkpoint_dir=shared, device='cpu')
    log['restored_step'] = again.state.step
    log['restored_equal'] = all(
        torch.equal(a, b) for a, b in zip(again.params.parameters(),
                                          opt.params.parameters()))

    # rank-local directories that disagree raise on every rank
    local = os.path.join(work, f'local_{rank}')
    os.makedirs(os.path.join(local, 'checkpoint_5') if rank == 0 else local)
    try:
        state_lib.restore_checkpoint(local, again.state)
    except RuntimeError as e:
        log['disagree_error'] = str(e)

    # a SIGTERM from the test reaches every rank at step 8: each rank
    # stops there, rank 0 checkpoints, and a new run resumes from it
    preempt = os.path.join(work, 'preempt')

    def handshake(o):
        if o.step == 8:
            open(os.path.join(work, f'ready_{rank}'), 'w').close()
            deadline = time.time() + 300
            while not os.path.exists(os.path.join(work, 'go')):
                if time.time() > deadline:
                    raise TimeoutError('no SIGTERM came from the test')
                time.sleep(0.01)

    opt = Optimizer({'num_iters': 20, 'lr_init': 1e-3, 'seed': 7}, pred,
                    crt, save_period=100, checkpoint_dir=preempt,
                    device='cpu')
    opt.run(BATCH, ts, crt, verbose=False, log_fns=[LogFn(handshake)])
    log['stopped_at'] = opt.step
    log['preempt_listing'] = sorted(os.listdir(preempt))
    resumed = Optimizer({'num_iters': 4, 'lr_init': 1e-3, 'seed': 7}, pred,
                        crt, checkpoint_dir=preempt, device='cpu')
    log['resumed_from'] = resumed.state.step
    losses = []
    resumed.run(BATCH, ts, crt, verbose=False,
                log_fns=[LogFn(lambda o: losses.append((o.step,
                                                        float(o.loss))))])
    log['resumed_losses'] = losses
    with open(os.path.join(work, f'integration_{rank}.json'), 'w') as f:
        json.dump(log, f)


def launch(job, world, work, *args, extra_env=None):
    """Start `world` ranks of `job` on a free localhost port, with
    `extra_env` added to a cluster-free environment; returns the
    processes (wait with `finish`)."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get('PYTHONPATH', '')) if p),
        OMP_NUM_THREADS='1')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE',
              'MASTER_ADDR', 'MASTER_PORT'):
        env.pop(k, None)
    env.update(extra_env or {})
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(rank),
         str(world), str(port), str(work), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(world)]


def finish(procs, timeout=240):
    """Wait for every rank; each must exit 0 and print WORKER_OK."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f'WORKER_OK {rank}' in out, \
            f'rank {rank} failed (exit {p.returncode}):\n{out}'
    return outs


def main():
    job, rank, world, port, work = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    ok = mesh_lib.initialize_distributed(
        coordinator_address=f'localhost:{port}', num_processes=world,
        process_id=rank, device='cpu')
    assert ok and dist.get_world_size() == world
    assert dist.get_backend() == 'gloo'
    if job == 'compute':
        compute(rank, work, sys.argv[6])
    elif job == 'integration':
        integration(rank, work)
    else:
        raise SystemExit(f'unknown job {job!r}')
    dist.barrier()
    dist.destroy_process_group()
    print(f'WORKER_OK {rank}', flush=True)


if __name__ == '__main__':
    main()
