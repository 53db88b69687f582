"""Benchmark: training-step throughput of the flagship recovery workload.

PyTorch counterpart of the repository's `bench.py`, on one CUDA card:

    python -m bhnerf_tpu_torch.bench

Workload as the reference's (SURVEY.md §6): 64x64 image-plane rays x
ngeo=100 samples, NeRF 4x128 + posenc deg 3, batch of 6 frames per step,
full-image chi^2 loss -- forward + backward + Adam update per step, the
render through the fused CUDA kernels (ops/csrc/fused_render.cu) on the
domain-compacted samples.

Prints ONE JSON line on stdout, with every key of the reference's line
(`main`), plus `power_limit_w` (nvidia-smi) and the torch and CUDA
versions; progress marks go to stderr. Headline metric:
  train_ray_samples_per_sec -- workload throughput counting every ray
  sample of the 64x64x100 grid (including the ~83% that the static
  domain compaction removes before the MLP).
Sections (one function each, the reference's names): the per-dispatch
step (`time_steps`), the chunked step (`make_scan_step`, `timed_reps`),
the ALMA-shaped 128x128x100 3-Stokes 'lc' step over a 10-variant
ensemble (`bench_alma_shape`), the EHT 'vis' step with the dense and the
factored operator (`bench_eht_step`), the device geodesic trace
(`bench_device_geos`) and the baseline (`bench_dense_baseline`). The
baseline is the port's plain PyTorch path: every ray sample of the
uncompacted table through the MLP as eager torch ops in float32, without
the compaction and the fused kernels. Its keys keep the reference's
names (`baseline_dense_xla_steps_per_sec`, `baseline_source`), so that
the two lines compare key by key.

`mfu` is the analytic matmul FLOPs (`mlp_flops_per_sample`, forward +
2x backward) over the card's dense bf16 peak (`PEAK_FLOPS`), the
reference's convention of the native matrix-unit peak whatever the
precision; a card missing from the table gives null.

A section that fails fails the run (non-zero exit): nothing falls back to
another path. Without a CUDA device `main` prints one JSON line whose
value is null, with an `error` key, and exits 2; it never measures on
the CPU. Each section function takes `device` and keywords for the sizes
the reference fixes inside it (defaults: the reference's), so that the
tests can run it small on the host.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

# dense bf16 tensor-core peak (FLOP/s) of each card, NVIDIA's data sheet;
# the H100 SXM at its 700 W limit
PEAK_FLOPS = {
    'NVIDIA H100 80GB HBM3': 989e12,
}

# the geodesic tables are cached as npz here (None: the temporary
# directory, tempfile.gettempdir())
CACHE_DIR = None


def mark(msg):
    print(f'# [{time.strftime("%H:%M:%S")}] {msg}', file=sys.stderr,
          flush=True)


def mlp_flops_per_sample(predictor):
    """Analytic fwd matmul FLOPs per sample (2*K*N per layer, true dims)."""
    from bhnerf_tpu_torch.models.fields import posenc_feature_dim
    in_dim = posenc_feature_dim(3, predictor.posenc_deg)
    skip = predictor.net_depth // 2 if predictor.do_skip else None
    dims, d = [], in_dim
    for i in range(predictor.net_depth):
        dims.append((d, predictor.net_width))
        d = predictor.net_width
        if predictor.do_skip and i > 0 and i % skip == 0:
            d += in_dim
    dims.append((d, predictor.out_channel))
    return 2 * sum(k * n for k, n in dims)


def synchronize(x):
    """Wait for the card's work on the device of tensor `x` (nothing on
    the CPU)."""
    if x.device.type == 'cuda':
        torch.cuda.synchronize(x.device)


def time_steps(grad_step, state, batch_args, rt, n_steps):
    """Steps/s of `n_steps` calls of grad_step after one warm-up call, and
    the last loss. batch_args: the full frame tensors on the device and,
    last, the batch's frame indices on the host, which go to the device
    with every call as the reference's numpy indices do."""
    *frames, inds = batch_args
    device = frames[0].device

    def step(state):
        idx = torch.as_tensor(np.asarray(inds)).to(device, torch.int64)
        return grad_step(state, *frames, idx, rt, 1.0)

    loss, state, _ = step(state)
    synchronize(loss)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        loss, state, _ = step(state)
    synchronize(loss)
    return n_steps / (time.perf_counter() - t0), float(loss)


def timed_reps(run_chunk, n_chunks, chunk_steps):
    """Median-of-reps timing (the reference's methodology). Runs
    `run_chunk(seq)` n_chunks times per rep -- seq is a monotone counter
    that seeds the chunk's draws; the callable returns the last device
    value to wait for -- and times each rep. BENCH_REPS (default 5)
    repeats in one process. Returns (median_steps_per_sec,
    per_rep_rates)."""
    reps = max(int(os.environ.get('BENCH_REPS', 5)), 1)
    rates, seq = [], 0
    for _ in range(reps):
        t0 = time.perf_counter()
        last = None
        for _ in range(n_chunks):
            seq += 1
            last = run_chunk(seq)
        synchronize(last)
        rates.append(n_chunks * chunk_steps / (time.perf_counter() - t0))
    return float(np.median(rates)), rates


def rand_indices(rng, nt, batch, n_steps):
    return [np.asarray(rng.choice(nt, batch, replace=False), np.int32)
            for _ in range(n_steps + 1)]


def chunk_draws(seq, nt, batch, chunk, device, num_variants=1):
    """A chunk's frame batches (chunk, batch) and variant numbers, drawn
    on the host from a generator seeded by `seq` (the reference derives
    them from jax.random.PRNGKey(seq) inside its scan); the batches go to
    the device in one copy, from pinned memory on the card, that does not
    block."""
    rng = np.random.default_rng(seq)
    idx = torch.as_tensor(np.stack(rand_indices(rng, nt, batch, chunk - 1)),
                          dtype=torch.int64)
    variants = (rng.integers(num_variants, size=chunk).tolist()
                if num_variants > 1 else [0] * chunk)
    if torch.device(device).type == 'cuda':
        idx = idx.pin_memory().to(device, non_blocking=True)
    else:
        idx = idx.to(device)
    return idx, variants


def card_info(device):
    """The card's name, power limit (W, nvidia-smi's `power.limit`; None
    where nvidia-smi does not run) and the torch and CUDA versions; the
    name is 'cpu' off the card."""
    device = torch.device(device)
    limit = None
    if device.type == 'cuda':
        try:
            out = subprocess.run(
                ['nvidia-smi', '--query-gpu=name,power.limit',
                 '--format=csv,noheader',
                 f'--id={device.index or 0}'],
                capture_output=True, text=True, timeout=60, check=True)
            limit = float(out.stdout.strip().splitlines()[0]
                          .rsplit(',', 1)[1].replace('W', ''))
        except (OSError, subprocess.SubprocessError, ValueError,
                IndexError):
            limit = None
    return {'chip': (torch.cuda.get_device_name(device)
                     if device.type == 'cuda' else 'cpu'),
            'power_limit_w': limit, 'torch_version': torch.__version__,
            'cuda_version': torch.version.cuda}


def peak_flops(device):
    """The dense bf16 peak of the card `device` (None off the table)."""
    device = torch.device(device)
    return (PEAK_FLOPS.get(torch.cuda.get_device_name(device))
            if device.type == 'cuda' else None)


def cache_path(kind, num, ngeo, fov, n_fine):
    """The npz of a cached host geodesic table: one per configuration,
    the tracer's fine steps included."""
    return os.path.join(CACHE_DIR or tempfile.gettempdir(),
                        f'bhnerf_tpu_torch_geos_{kind}_{num}x{num}x{ngeo}'
                        f'_f{fov}_n{n_fine}.npz')


def cached_geos(kind, spin, inclination, fov, num, ngeo, n_fine):
    """The host float64 table of a square screen of side `fov`, loaded
    from its cache (cache_path) or traced and saved there."""
    from bhnerf_tpu_torch.geodesics import image_plane_geos
    from bhnerf_tpu_torch.geodesics.dataset import Geodesics
    cache = cache_path(kind, num, ngeo, fov, n_fine)
    if os.path.exists(cache):
        return Geodesics.load(cache)
    geos = image_plane_geos(
        spin=spin, inclination=inclination, alpha_range=(-fov / 2, fov / 2),
        beta_range=(-fov / 2, fov / 2), ngeo=ngeo, num_alpha=num,
        num_beta=num, n_fine=n_fine)
    geos.save(cache)
    return geos


def synthetic_polarized_rt(num, ngeo, fov, predictor, seed=0,
                           device='cuda'):
    """ALMA-flagship-SHAPED ray constants without the f64 geodesic trace.

    Training-step cost depends on shapes and the in-domain fraction, not
    on the physical values; sampling coords uniformly in the fov cube
    reproduces the production compaction ratio at 128x128x100 with a
    3-Stokes J. The numpy draws are the reference's, in its order, so the
    arrays are bitwise its own; they go to `device` as float32.
    """
    from bhnerf_tpu_torch.train.step import RayTracingArgs
    del predictor       # the reference's signature

    rng = np.random.default_rng(seed)
    shape = (num, num, ngeo)
    coords = rng.uniform(-fov / 2, fov / 2,
                         size=(3, *shape)).astype(np.float32)
    J = rng.uniform(0.2, 1.0, size=(3, *shape)).astype(np.float32)
    pos = lambda: rng.uniform(0.5, 1.0, size=shape).astype(np.float32)
    g, dtau, Sigma = pos(), pos(), pos()
    t_geos_rel = rng.uniform(900.0, 1100.0, size=shape).astype(np.float32)
    put = lambda x: torch.as_tensor(x).to(device)
    return RayTracingArgs(
        coords=put(coords),
        Omega=torch.tensor(0.05, dtype=torch.float32, device=device),
        J=put(J), g=put(g), dtau=put(dtau), Sigma=put(Sigma),
        t_geos_rel=put(t_geos_rel),
        t_injection=torch.zeros((), dtype=torch.float32, device=device),
        t_start_obs=0.0, t_to_M=500.0, t_units=None)


def fresh_state(predictor, device):
    """Seed-0 parameters and Adam over a 50,000-step schedule."""
    from bhnerf_tpu_torch.train import TrainState, make_optimizer
    return TrainState.create(
        predictor.init_params(generator=torch.Generator().manual_seed(0),
                              device=device),
        make_optimizer(50000))


def headline_problem(device='cuda', num=64, ngeo=100, nt=64, n_fine=4096,
                     compute_dtype='bfloat16'):
    """The headline problem (reference bench.py:337-378): spin 0.2, 60
    deg, fov 16, num x num rays x ngeo samples traced on the host at
    n_fine fine steps (cached, cached_geos), nt frames over 200 M, the
    4x128 posenc-3 predictor with rmin 3, the compacted constants, the
    in-domain count n_eff, and a seeded target with one frame batch.
    Returns a namespace of them; batch_args are (target, sigma, offset,
    t_all) on `device` and the batch's indices on the host."""
    from bhnerf_tpu_torch import constants, emission, units
    from bhnerf_tpu_torch.models import NeRFPredictor
    from bhnerf_tpu_torch.train import raytracing_args
    from bhnerf_tpu_torch.train.step import compact_raytracing_args

    batch, fov = 6, 16.0
    geos = cached_geos('bench', 0.2, np.deg2rad(60.0), fov, num, ngeo,
                       n_fine)
    Omega = geos.keplerian_omega()
    t_injection = -float(geos.r_o + fov / 4)
    GM_hr = constants.GM_c3(constants.sgra_mass).to('hr').value
    t_frames = np.linspace(0.0, 200.0 * GM_hr, nt).astype(np.float32)
    rt = raytracing_args(geos, Omega, t_injection,
                         units.Quantity(t_frames[0], 'hr'), device=device)
    predictor = NeRFPredictor(scale=fov / 2, rmin=3.0, rmax=fov / 2,
                              z_width=2.0, net_depth=4, net_width=128,
                              posenc_deg=3, compute_dtype=compute_dtype)
    crt = compact_raytracing_args(rt, predictor)
    n_eff = int(emission.domain_mask(rt.coords, predictor.rmin,
                                     predictor.rmax,
                                     predictor.z_width).sum())
    rng = np.random.default_rng(0)
    put = lambda x: torch.as_tensor(x).to(device)
    target = put(rng.random((nt, num, num), dtype=np.float32))
    inds = np.asarray(rng.choice(nt, batch, replace=False), np.int32)
    batch_args = (target, torch.ones_like(target), torch.zeros_like(target),
                  put(t_frames), inds)
    return types.SimpleNamespace(
        geos=geos, rt=rt, crt=crt, predictor=predictor, n_eff=n_eff,
        batch_args=batch_args, num=num, ngeo=ngeo, nt=nt, batch=batch,
        device=torch.device(device))


def bench_per_dispatch(problem, n_steps=50):
    """The fused step one dispatch at a time (reference bench.py:385-408):
    make_step_fns(kind='image', dtype='full', fused=True), the
    reference's gather=True form, over n_steps steps of one batch.
    Returns (steps/s, the last loss)."""
    from bhnerf_tpu_torch.train.step import make_step_fns
    grad_step, _ = make_step_fns(problem.predictor, kind='image',
                                 dtype='full', fused=True)
    return time_steps(grad_step, fresh_state(problem.predictor,
                                             problem.device),
                      problem.batch_args, problem.crt, n_steps)


def bench_scan(problem, chunk=500, steps=1000):
    """The chunked step (reference bench.py:411-442): make_scan_step's
    chunks of `chunk` fused steps with the frame batches drawn on the
    host (chunk_draws), one warm-up chunk, then `steps` steps a rep
    (timed_reps). Returns (median steps/s, per-rep rates)."""
    from bhnerf_tpu_torch.train.step import make_scan_step
    scan_fn = make_scan_step(predictor=problem.predictor, kind='image',
                             dtype='full', fused=True,
                             batchsize=problem.batch, chunk=chunk)
    frames = problem.batch_args[:4]
    state = fresh_state(problem.predictor, problem.device)

    def run_chunk(seq):
        nonlocal state
        idx, variants = chunk_draws(seq, problem.nt, problem.batch, chunk,
                                    problem.device)
        state, losses = scan_fn(state, *frames, idx, variants, problem.crt,
                                1.0)
        return losses

    synchronize(run_chunk(0))
    return timed_reps(run_chunk, max(steps // chunk, 1), chunk)


def bench_alma_shape(predictor_base, mark, num_variants=10, chunk=100,
                     device='cuda', num=128, ngeo=100, nt=64, steps=600):
    """Polarized flagship workload: num x num rays x ngeo, 3 Stokes, lc
    loss, a sub-pixel ensemble of num_variants, chunks of `chunk` steps
    with each step's variant drawn on the host (the port's chunk picks
    it from the list of compacted variants; no stacked copy), `steps`
    steps a rep. The synthetic tables and their compaction are set-up,
    outside the timed window."""
    from bhnerf_tpu_torch.train.step import (compact_ensemble_args,
                                             make_scan_step)

    fov, batch = 16.0, 6
    predictor = dataclasses.replace(predictor_base, rmin=3.0)
    t0 = time.perf_counter()
    rt_list = [synthetic_polarized_rt(num, ngeo, fov, predictor, seed=s,
                                      device=device)
               for s in range(num_variants)]
    # lc losses never materialize per-pixel images (train.step routes
    # them through the em @ W^T matmul), so the packed 'gather' layout is
    # the one here
    crt_list = compact_ensemble_args(rt_list, predictor, layout='gather')
    del rt_list
    n_eff = crt_list[0].coords.shape[-1]
    mark(f'alma-shape: {num_variants} variants of {num}x{num}x{ngeo} '
         f'compacted to N = {n_eff} in {time.perf_counter() - t0:.1f} s')

    rng = np.random.default_rng(1)
    target = torch.as_tensor(rng.random((nt, 3), dtype=np.float32)).to(device)
    sigma, offset = torch.ones_like(target), torch.zeros_like(target)
    t_all = torch.as_tensor(np.linspace(0.0, 1.0, nt, dtype=np.float32)).to(
        device)

    scan_fn = make_scan_step(predictor=predictor, kind='image', dtype='lc',
                             fused=True, batchsize=batch, chunk=chunk)
    state = fresh_state(predictor, device)

    def run_chunk(seq):
        nonlocal state
        idx, variants = chunk_draws(seq, nt, batch, chunk, device,
                                    num_variants)
        state, losses = scan_fn(state, target, sigma, offset, t_all, idx,
                                variants, crt_list, 1.0)
        return losses

    synchronize(run_chunk(0))
    steps_per_sec, rates = timed_reps(run_chunk, max(steps // chunk, 1),
                                      chunk)
    mark(f'alma-shape ensemble({num_variants}) path: '
         f'{steps_per_sec:.2f} steps/s median of {len(rates)} '
         f'[{min(rates):.1f}, {max(rates):.1f}]')
    # the headline mfu's convention: useful matmul FLOPs (fwd + 2x bwd)
    # over the card's bf16 peak
    peak = peak_flops(device)
    alma_flops = (3 * mlp_flops_per_sample(predictor) * n_eff * batch
                  * steps_per_sec)
    return {
        'alma_steps_per_sec': round(steps_per_sec, 2),
        'alma_steps_per_sec_spread': [round(min(rates), 2),
                                      round(max(rates), 2)],
        'alma_ray_samples_per_sec': round(
            steps_per_sec * batch * num * num * ngeo),
        'alma_mlp_samples_per_sec': round(steps_per_sec * batch * n_eff),
        'alma_mfu': round(alma_flops / peak, 4) if peak else None,
        'alma_num_variants': num_variants,
        'alma_shape': [num, num, ngeo, 3],
    }


def bench_eht_step(predictor, geos, rt, crt, t_frames_hr, mark, chunk=250,
                   n_chunks=2, device='cuda'):
    """Visibility-loss (north-star) training-step throughput: ngEHT
    thermal-noise synthesis -> complex-vis chi^2, compact+fused, chunked,
    for the dense and the factored operator: one warm chunk of `chunk`
    steps, then n_chunks timed. Same geometry/predictor as the headline
    image workload so the two steps/s are directly comparable."""
    from bhnerf_tpu_torch import constants, observation, units
    from bhnerf_tpu_torch.train import TrainStep
    from bhnerf_tpu_torch.train.step import make_scan_step
    from bhnerf_tpu_torch.tutorials import array_path
    del rt              # the reference's signature

    nt, batch = len(t_frames_hr), 6
    num = geos.num_alpha
    rng = np.random.default_rng(0)
    movie = rng.random((nt, num, num), dtype=np.float32)
    array = observation.load_txt(array_path('ngEHT.txt'))
    obs_empty = observation.empty_eht_obs(array, nt=nt, tint=30.0)
    fov_M = float(geos.alpha.max() - geos.alpha.min())
    fov_rad = float(fov_M * constants.GM_c2(constants.sgra_mass).value
                    / constants.sgra_distance.to('m').value)
    obs = observation.observe_same(movie, np.asarray(t_frames_hr),
                                   fov_rad / num, obs_empty,
                                   thermal_noise=True, seed=0)
    out = {}
    for op in ('dense', 'factored'):
        train_step = TrainStep.eht(
            units.Quantity(np.asarray(t_frames_hr, np.float32), 'hr'),
            obs, fov_rad, num, predictor, dtype='vis', fused=True,
            operator=op, device=device)
        scan_fn = make_scan_step(batchsize=batch, chunk=chunk,
                                 **train_step.scan_meta)
        state = fresh_state(predictor, device)
        dev_args = train_step.args[0].device_args

        def run_chunk(seq):
            nonlocal state
            idx, variants = chunk_draws(seq, nt, batch, chunk, device)
            state, losses = scan_fn(state, *dev_args, idx, variants, crt,
                                    1.0)
            return losses

        synchronize(run_chunk(0))
        t0 = time.perf_counter()
        for i in range(n_chunks):
            losses = run_chunk(1 + i)
        synchronize(losses)
        steps_per_sec = n_chunks * chunk / (time.perf_counter() - t0)
        mark(f'eht (vis-loss, {op} operator) path: '
             f'{steps_per_sec:.2f} steps/s')
        key = ('eht_steps_per_sec' if op == 'dense'
               else 'eht_factored_steps_per_sec')
        out[key] = round(steps_per_sec, 2)
        if op == 'dense':
            out['eht_nvis_per_frame'] = int(dev_args[2].shape[-2])
    return out


def bench_device_geos(mark, n=64, ngeo=100, n_fine=8192, device='cuda'):
    """The float32 geodesic trace on the card (ops/csrc/geodesic_trace.cu;
    warm: one call first): the chi^2 grid scans re-trace one table per
    grid point and sub-pixel variant, so seconds a table is the scan
    currency."""
    from bhnerf_tpu_torch.geodesics import image_plane_geos
    kw = dict(spin=0.94, inclination=np.deg2rad(60), alpha_range=(-8, 8),
              beta_range=(-8, 8), ngeo=ngeo, num_alpha=n, num_beta=n,
              n_fine=n_fine, backend='device', device=device)
    image_plane_geos(**kw)                        # builds the kernel
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    image_plane_geos(**kw)
    dt = time.perf_counter() - t0
    mark(f'device f32 geodesic trace ({n}x{n}x{ngeo}): {dt:.2f} s/table')
    return {'geos_device_trace_s': round(dt, 3)}


def bench_dense_baseline(problem, mark, n_steps=10):
    """The baseline: the plain PyTorch step (fused=False) in float32 over
    the uncompacted table, every ray sample through the MLP as eager
    torch ops (the reference semantics of network.py:566-682 without the
    domain compaction and the fused kernels). Returns steps/s; marks the
    device memory it peaks at."""
    from bhnerf_tpu_torch.train.step import make_step_fns
    device = problem.device
    base_pred = dataclasses.replace(problem.predictor,
                                    compute_dtype='float32')
    base_step, _ = make_step_fns(base_pred, kind='image', dtype='full',
                                 fused=False)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    steps_per_sec, _ = time_steps(base_step, fresh_state(base_pred, device),
                                  problem.batch_args, problem.rt, n_steps)
    if device.type == 'cuda':
        mark(f'dense baseline: {steps_per_sec:.2f} steps/s, peak device '
             f'memory {torch.cuda.max_memory_allocated(device)} B')
    return steps_per_sec


def run(device='cuda'):
    """Every section on `device` in the reference's order; returns the
    JSON line's dict."""
    compute_dtype = os.environ.get('BENCH_COMPUTE_DTYPE', 'bfloat16')
    scan_chunk = int(os.environ.get('BENCH_SCAN_CHUNK', 500))
    info = card_info(device)
    mark(f'{info["chip"]}, {info["power_limit_w"]} W, torch '
         f'{info["torch_version"]}, CUDA {info["cuda_version"]}; geodesics')
    p = headline_problem(device, compute_dtype=compute_dtype)
    mark(f'geodesics done, N = {p.crt.coords.shape[1]} (n_eff {p.n_eff}); '
         f'fused train step')

    steps_per_sec, loss = bench_per_dispatch(p)
    mark(f'fused path: {steps_per_sec:.2f} steps/s; chunked step')
    scan_steps_per_sec, scan_rates = bench_scan(p, chunk=scan_chunk)
    scan_spread = [round(min(scan_rates), 2), round(max(scan_rates), 2)]
    mark(f'scan path: {scan_steps_per_sec:.2f} steps/s; alma-shape '
         'ensemble step')
    alma_keys = bench_alma_shape(p.predictor, mark, device=device)
    eht_keys = bench_eht_step(p.predictor, p.geos, p.rt, p.crt,
                              np.linspace(4.0, 15.5, p.nt).astype(np.float32),
                              mark, device=device)
    geos_keys = bench_device_geos(mark, device=device)
    mark('dense baseline')
    base_steps_per_sec = bench_dense_baseline(p, mark)

    num, ngeo, batch = p.num, p.ngeo, p.batch
    best = max(steps_per_sec, scan_steps_per_sec)
    flops_fwd = mlp_flops_per_sample(p.predictor)
    model_flops_per_step = 3 * flops_fwd * p.n_eff * batch  # fwd + bwd(2x)
    model_tflops = model_flops_per_step * best / 1e12
    peak = peak_flops(device)
    mfu = model_tflops * 1e12 / peak if peak else None
    mark(f'steps/sec: {best:.2f} (per-dispatch {steps_per_sec:.2f}, plain '
         f'baseline {base_steps_per_sec:.2f}), loss {loss:.3f}')
    return {
        'metric': 'train_ray_samples_per_sec',
        'value': round(best * batch * num * num * ngeo),
        'unit': 'samples/s',
        'vs_baseline': round(best / base_steps_per_sec, 3),
        'steps_per_sec': round(best, 2),
        # median + spread of the winning path's repeated runs (the
        # per-dispatch path is timed once; spread is null if it wins)
        'steps_per_sec_median': round(best, 2),
        'steps_per_sec_spread': (scan_spread
                                 if scan_steps_per_sec >= steps_per_sec
                                 else None),
        'per_dispatch_steps_per_sec': round(steps_per_sec, 2),
        'scan_steps_per_sec': round(scan_steps_per_sec, 2),
        'scan_steps_per_sec_spread': scan_spread,
        'baseline_dense_xla_steps_per_sec': round(base_steps_per_sec, 2),
        'baseline_source': 'measured',
        'mlp_samples_per_sec': round(best * batch * p.n_eff),
        'model_tflops': round(model_tflops, 2),
        'mfu': round(mfu, 4) if mfu is not None else None,
        'peak_tflops': peak / 1e12 if peak else None,
        'chip': info['chip'],
        'compute_dtype': compute_dtype,
        **alma_keys,
        **eht_keys,
        **geos_keys,
        'power_limit_w': info['power_limit_w'],
        'torch_version': info['torch_version'],
        'cuda_version': info['cuda_version'],
    }


def main():
    if not torch.cuda.is_available():
        # value null + rc 2: no card must never read as a measured 0
        print(json.dumps({
            'metric': 'train_ray_samples_per_sec', 'value': None,
            'unit': 'samples/s', 'vs_baseline': None,
            'error': 'no CUDA device'}))
        print('# no CUDA device; see error key', file=sys.stderr)
        return 2
    print(json.dumps(run(torch.device('cuda', 0))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
