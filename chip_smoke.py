"""GPU smoke run of bhnerf_tpu_torch: build the kernels, hold them against
their plain versions at the main path's shapes, and train a few steps of
the Tutorial-3 image fit at full width on one CUDA device.

Run from the repository root on a machine with an NVIDIA Hopper GPU and
nvcc:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles csrc/*.cu for sm_90a and prints the build seconds;
  3. host precompute: f64 geodesics (64x64 rays x 100 samples), ray
     constants, domain compaction (the 'gather' layout);
  4. kernels vs plain versions at the compacted sample count N and a
     6-frame batch: forward in f32 and bf16 (with and without the stash,
     and at a sample count that is no multiple of its 128-column tile),
     its occupancy, backward with and without the frame-time cotangent;
     max errors and milliseconds of both;
  5. main path: TrainStep.image(fused=True) + Optimizer.run for 20 steps
     of batch 6 on the card, with launch counters proving that every step
     went through both kernels, finite and decreasing losses, steps/s;
  6. torch.profiler over 10 more steps: the device's busy share of a step
     and each kernel's share of the device time.
The line before the last is the JSON kernel summary; the last line is
{"ok": true, "device": {...}}.
"""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NUM_RAYS = 64           # rays per image side
NGEO = 100              # samples per ray
N_FINE = 4096           # pass-1 fine steps of the geodesic tracer
NT = 64                 # movie frames
BATCH = 6               # frames per step
FOV = 16.0
STEPS = 20
REPEATS = 20            # launches per timing
# published dense peaks of one H100 SXM (NVIDIA's data sheet): TF32 tensor
# cores and HBM3
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12


def log(msg):
    print(msg, flush=True)


def card_info():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats=REPEATS):
    """Mean milliseconds of fn() on the current stream (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def mlp_dims(cfg, feat):
    """(in, out) of every layer of the MLP, head last, with the skip
    concatenation after layer depth // 2 (models/fields.py)."""
    from bhnerf_tpu_torch.models.fields import skip_after
    depth, width, do_skip = cfg
    dims, d_in = [], feat
    for i in range(depth + 1):
        d_out = width if i < depth else 1
        dims.append((d_in, d_out))
        d_in = width + (feat if skip_after(i, depth, do_skip) else 0)
    return dims


def bound(kind, cfg, feat, nt, n, n_params, compute_dtype, want_dt=False):
    """(bound_ms, bound_by, tera-ops): the least time the card could take
    for this call. Operations: 2 per multiply-add of the products, TF32
    on the tensor cores, three products each in f32 mode (3xTF32), one
    in bf16 mode; forward = the layer products, backward = recompute +
    weight gradients + products back through the weights (layer 0's only
    with want_dt). Bytes: each input read once and each output written
    once (forward: per-sample rows, frame times, parameters, emission;
    backward: g_em, emission, stashed features, omega, parameters,
    gradients)."""
    cols = nt * n
    macs = [i * o for i, o in mlp_dims(cfg, feat)]
    if kind == 'fwd':
        flop = 2 * cols * sum(macs)
        nbytes = 4 * (6 * n + nt + n_params + cols)
    else:
        back = sum(macs[1:]) + (macs[0] if want_dt else 0)
        flop = 2 * cols * (2 * sum(macs) + back)
        nbytes = 4 * ((2 + feat) * cols + n + 2 * n_params + 2 * nt)
    ops = flop * (3 if compute_dtype == 'float32' else 1)
    t_ops, t_bytes = ops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', ops / 1e12)


def host_precompute(device):
    from bhnerf_tpu_torch import constants, units
    from bhnerf_tpu_torch.geodesics import image_plane_geos
    from bhnerf_tpu_torch.models.fields import NeRFPredictor
    from bhnerf_tpu_torch.train.step import (compact_raytracing_args,
                                             raytracing_args)
    t0 = time.perf_counter()
    geos = image_plane_geos(spin=0.2, inclination=np.deg2rad(60.0),
                            alpha_range=(-FOV / 2, FOV / 2),
                            beta_range=(-FOV / 2, FOV / 2), ngeo=NGEO,
                            num_alpha=NUM_RAYS, num_beta=NUM_RAYS,
                            n_fine=N_FINE)
    t_geo = time.perf_counter() - t0
    for f in ('r', 'theta', 'phi', 't'):
        if not np.isfinite(getattr(geos, f)).all():
            raise RuntimeError(f'non-finite geodesic table {f}')
    t_injection = -float(geos.r_o + FOV / 4)
    GM_hr = constants.GM_c3(constants.sgra_mass).to('hr').value
    t_frames = np.linspace(0.0, 200.0 * GM_hr, NT).astype(np.float32)
    rt = raytracing_args(geos, geos.keplerian_omega(), t_injection,
                         units.Quantity(t_frames[0], 'hr'), device=device)
    predictor = NeRFPredictor(scale=FOV / 2, rmin=3.0, rmax=FOV / 2,
                              z_width=2.0, net_depth=4, net_width=128,
                              posenc_deg=3)
    crt = compact_raytracing_args(rt, predictor)
    n_dense = NUM_RAYS * NUM_RAYS * NGEO
    n_in = int((crt.t_geos_rel > -1e29).sum())
    log(f'host precompute: geodesics {NUM_RAYS}x{NUM_RAYS}x{NGEO} '
        f'(n_fine {N_FINE}, f64) in {t_geo:.1f} s; compacted '
        f'{n_in}/{n_dense} samples ({100 * n_in / n_dense:.1f}%), padded '
        f'N = {crt.coords.shape[1]}')
    return predictor, crt, t_frames


def kernel_checks(predictor, crt, t_frames, device):
    """Both kernels against their plain versions on the card at the main
    path's shapes. Returns the JSON entries (launches filled in later)."""
    import ctypes

    import torch
    from bhnerf_tpu_torch.ops import _build, fused

    rng = np.random.default_rng(0)
    n = crt.coords.shape[1]
    cfg = (predictor.net_depth, predictor.net_width, predictor.do_skip)
    deg = predictor.posenc_deg
    params = predictor.init_params(
        generator=torch.Generator().manual_seed(0), device=device)
    weights = [w.detach() for w in fused.pack_params(params)[0]]
    biases = [b.detach() for b in fused.pack_params(params)[1]]
    # lift the head so emissions and gradients are macroscopic
    biases[-1] = biases[-1] + 8.0
    t_frames_M = crt.frame_times_M(torch.as_tensor(
        t_frames[rng.choice(NT, BATCH, replace=False)], device=device))
    coords, omega, tg, smask, _ = fused._flatten_sample_args(
        crt.coords, crt.Omega, crt.t_geos_rel, 1.0, n)
    t_eff = (t_frames_M.reshape(-1, 1) - crt.t_injection).contiguous()
    common = (t_eff, coords, omega, tg, smask, weights, biases, cfg,
              predictor.scale, deg)

    em_k, f_k = fused.render_fwd(*common, 'float32', stash=True)
    em_p, f_p = fused.render_fwd_plain(*common, 'float32', stash=True)
    torch.cuda.synchronize()
    fwd_err = float((em_k - em_p).abs().max())
    ok = torch.allclose(em_k, em_p, atol=2e-6, rtol=1e-4)
    f_err = float((f_k - f_p).abs().max())
    log(f'fwd f32: max|em_kernel - em_plain| = {fwd_err:.3e} (atol 2e-6, '
        f'rtol 1e-4: {"ok" if ok else "FAIL"}); features {f_err:.3e}')
    if not ok or f_err > 1e-5:
        raise RuntimeError('forward kernel disagrees with its plain version')
    fwd_ms = cuda_ms(lambda: fused.render_fwd(*common, 'float32'))
    fwd_plain_ms = cuda_ms(lambda: fused.render_fwd_plain(*common,
                                                          'float32'))
    fwd_stash_ms = cuda_ms(lambda: fused.render_fwd(*common, 'float32',
                                                    stash=True))
    # the forward walks 128-column tiles of the flat (frame, sample) list:
    # a sample count that is a multiple of 64 only, over 5 frames, makes
    # tiles straddle frames and leaves the last one short
    odd = (t_eff[:5].contiguous(),
           *(x[:, :n - 64].contiguous() for x in (coords, omega, tg, smask)),
           *common[5:])
    em_o = fused.render_fwd(*odd, 'float32')
    em_op = fused.render_fwd_plain(*odd, 'float32')
    torch.cuda.synchronize()
    odd_err = float((em_o - em_op).abs().max())
    log(f'fwd f32 at N = {n - 64} (not a multiple of 128), 5 frames: '
        f'max|em_kernel - em_plain| = {odd_err:.3e} (atol 2e-6, rtol 1e-4)')
    if not torch.allclose(em_o, em_op, atol=2e-6, rtol=1e-4):
        raise RuntimeError('forward kernel disagrees at a short last tile')
    occ = [ctypes.c_int(), ctypes.c_int()]
    _build.check(fused._lib().fused_render_fwd_occupancy(
        *cfg[:2], f_p.shape[0], int(cfg[2]), 0, ctypes.byref(occ[0]),
        ctypes.byref(occ[1])), 'fused_render_fwd_occupancy')
    fwd_warps = occ[0].value * occ[1].value // 32
    log(f'fwd occupancy: {occ[0].value} block(s) of {occ[1].value} threads '
        f'per SM = {fwd_warps} warps per SM')
    n_params = sum(w.numel() + b.numel() for w, b in zip(weights, biases))
    fwd_bound = bound('fwd', cfg, f_p.shape[0], BATCH, n, n_params,
                      'float32')
    log(f'fwd f32: kernel {fwd_ms:.3f} ms (with stash {fwd_stash_ms:.3f} '
        f'ms), plain {fwd_plain_ms:.3f} ms; bound {fwd_bound[0]:.3f} ms '
        f'({fwd_bound[1]}: {fwd_bound[2]:.1f} T TF32 ops), kernel at '
        f'{100 * fwd_bound[0] / fwd_ms:.1f}% of it')

    target = torch.as_tensor(rng.random(em_p.shape), dtype=torch.float32,
                             device=device)
    g_em = (2.0 * (em_p - target)).contiguous()
    bwd = {}
    for want_dt in (False, True):
        gk = fused.render_bwd(g_em, em_p, f_p, omega, weights, biases, cfg,
                              deg, 'float32', want_dt)
        gp = fused.render_bwd_plain(g_em, em_p, f_p, omega, weights, biases,
                                    cfg, deg, 'float32', want_dt)
        torch.cuda.synchronize()
        err, norm_err = 0.0, 0.0
        for a, b in zip(gp[0] + gp[1], gk[0] + gk[1]):
            err = max(err, float((a - b).abs().max()))
            norm_err = max(norm_err, float((a - b).abs().max()
                                           / (a.abs().max() + 1e-8)))
        line = (f'bwd f32 want_dt={want_dt}: max|dW_kernel - dW_plain| = '
                f'{err:.3e}, normalised {norm_err:.3e} (atol 5e-5)')
        if norm_err > 5e-5:
            raise RuntimeError(f'backward kernel disagrees: {line}')
        if want_dt:
            dt_rel = float(((gk[2] - gp[2]).abs()
                            / (gp[2].abs() + 1e-12)).max())
            line += f'; d_t rel err {dt_rel:.3e} (rtol 2e-3)'
            if dt_rel > 2e-3 or not bool((gp[2].abs() > 0).all()):
                raise RuntimeError(f'frame-time cotangent disagrees: {line}')
        # deterministic: the same call twice gives bitwise the same sums
        again = fused.render_bwd(g_em, em_p, f_p, omega, weights, biases,
                                 cfg, deg, 'float32', want_dt)
        same = all(torch.equal(a, b) for a, b in
                   zip(gk[0] + gk[1] + [gk[2]],
                       again[0] + again[1] + [again[2]]))
        if not same:
            raise RuntimeError('backward kernel is not deterministic')
        k_ms = cuda_ms(lambda: fused.render_bwd(
            g_em, em_p, f_p, omega, weights, biases, cfg, deg, 'float32',
            want_dt))
        p_ms = cuda_ms(lambda: fused.render_bwd_plain(
            g_em, em_p, f_p, omega, weights, biases, cfg, deg, 'float32',
            want_dt))
        b_ms, b_by, b_tops = bound('bwd', cfg, f_p.shape[0], *g_em.shape,
                                   n_params, 'float32', want_dt)
        log(f'{line}; bitwise repeatable; kernel {k_ms:.3f} ms, plain '
            f'{p_ms:.3f} ms; bound {b_ms:.3f} ms ({b_by}: {b_tops:.1f} '
            f'T TF32 ops), kernel at {100 * b_ms / k_ms:.1f}% of it')
        bwd[want_dt] = (err, k_ms, p_ms, b_ms, b_by)

    # bf16 operands against the f32 plain version (test_fused.py:83-114)
    em_b, f_b = fused.render_fwd(*common, 'bfloat16', stash=True)
    loss_ref = float(((em_p - target) ** 2).sum())
    loss_b = float(((em_b - target) ** 2).sum())
    g_b = (2.0 * (em_b - target)).contiguous()
    gk = fused.render_bwd(g_b, em_b, f_b, omega, weights, biases, cfg, deg,
                          'bfloat16', False)
    gp = fused.render_bwd_plain(g_em, em_p, f_p, omega, weights, biases,
                                cfg, deg, 'float32', False)
    cos = min(float(torch.nn.functional.cosine_similarity(
        a.reshape(1, -1), b.reshape(1, -1))) for a, b in
        zip(gp[0] + gp[1], gk[0] + gk[1]))
    loss_rel = abs(loss_b - loss_ref) / loss_ref
    b_ms = cuda_ms(lambda: fused.render_fwd(*common, 'bfloat16'))
    bs_ms = cuda_ms(lambda: fused.render_fwd(*common, 'bfloat16',
                                             stash=True))
    bp_ms = cuda_ms(lambda: fused.render_fwd_plain(*common, 'bfloat16'))
    bb_ms = cuda_ms(lambda: fused.render_bwd(
        g_b, em_b, f_b, omega, weights, biases, cfg, deg, 'bfloat16', False))
    bbp_ms = cuda_ms(lambda: fused.render_bwd_plain(
        g_b, em_b, f_b, omega, weights, biases, cfg, deg, 'bfloat16', False))
    log(f'bf16 vs f32 plain: loss rel diff {loss_rel:.3e} (< 0.02), min '
        f'per-matrix gradient cosine {cos:.6f} (> 0.99); fwd kernel '
        f'{b_ms:.3f} ms (with stash {bs_ms:.3f} ms), plain {bp_ms:.3f} ms; '
        f'bwd kernel {bb_ms:.3f} ms, plain {bbp_ms:.3f} ms')
    if loss_rel > 0.02 or cos < 0.99:
        raise RuntimeError('bf16 kernels stray from the f32 reference')

    # library_ms: no single PyTorch call computes either fused function
    # (warp + posenc + a 5-layer MLP with a skip, and its backward)
    return [
        {'name': 'fused_render_fwd', 'route': 'cuda',
         'source': 'bhnerf_tpu_torch/ops/csrc/fused_render.cu',
         'replaces': 'bhnerf_tpu/ops/fused.py:169', 'launches': 0,
         'launches_per_step': 0, 'max_abs_err': fwd_err, 'ms': fwd_ms,
         'plain_ms': fwd_plain_ms, 'bound_ms': fwd_bound[0],
         'bound_by': fwd_bound[1], 'library_ms': None,
         'stash_ms': fwd_stash_ms, 'bf16_ms': b_ms, 'bf16_stash_ms': bs_ms,
         'bf16_plain_ms': bp_ms, 'warps_per_sm': fwd_warps},
        {'name': 'fused_render_bwd', 'route': 'cuda',
         'source': 'bhnerf_tpu_torch/ops/csrc/fused_render.cu',
         'replaces': 'bhnerf_tpu/ops/fused.py:198', 'launches': 0,
         'launches_per_step': 0,
         'max_abs_err': max(bwd[False][0], bwd[True][0]),
         'ms': bwd[False][1], 'plain_ms': bwd[False][2],
         'bound_ms': bwd[False][3], 'bound_by': bwd[False][4],
         'library_ms': None, 'want_dt_ms': bwd[True][1],
         'bf16_ms': bb_ms, 'bf16_plain_ms': bbp_ms},
    ]


def train_main_path(predictor, crt, t_frames, device):
    """The Tutorial-3 image fit through the port's entry points."""
    import torch
    from bhnerf_tpu_torch import units
    from bhnerf_tpu_torch.ops import fused
    from bhnerf_tpu_torch.train.optimizer import LogFn, Optimizer, TrainStep

    rng = np.random.default_rng(1)
    # one numpy-seeded target image for every frame, well above the
    # initial model's images, so the loss falls however the batches fall
    target = np.repeat(
        0.02 * rng.random((1, NUM_RAYS, NUM_RAYS), dtype=np.float32), NT,
        axis=0)
    train_step = TrainStep.image(units.Quantity(t_frames, 'hr'), target,
                                 predictor, dtype='full', fused=True,
                                 device=device)
    opt = Optimizer({'num_iters': STEPS, 'lr_init': 1e-3, 'lr_final': 1e-4,
                     'seed': 0}, predictor, crt, device=device)
    losses, stamps = [], []

    def record(o):
        losses.append(float(o.loss))    # synchronises: one step per stamp
        stamps.append(time.perf_counter())

    fused.render_fwd.launches = 0
    fused.render_bwd.launches = 0
    opt.run(BATCH, train_step, crt, log_fns=[LogFn(record)], verbose=False)
    torch.cuda.synchronize()
    launches = (fused.render_fwd.launches, fused.render_bwd.launches)
    steps_per_s = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    log(f'main path: {STEPS} steps at batch {BATCH}, losses '
        f'{losses[0]:.6g} -> {losses[-1]:.6g}; launches fwd {launches[0]}, '
        f'bwd {launches[1]}; {steps_per_s:.2f} steps/s over steps 2..'
        f'{STEPS} ({steps_per_s * BATCH * crt.coords.shape[1] / 1e6:.1f} M '
        f'sample-frames/s)')
    if launches[0] < STEPS or launches[1] < STEPS:
        raise RuntimeError(f'main path did not go through the kernels: '
                           f'{launches}')
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f'non-finite loss: {losses}')
    if not losses[-1] < losses[0]:
        raise RuntimeError(f'loss did not fall: {losses}')
    with torch.no_grad():
        images = train_step(opt.state, crt, np.arange(BATCH),
                            update_state=False)[2]
    if tuple(images.shape) != (BATCH, NUM_RAYS, NUM_RAYS) or \
            not bool(torch.isfinite(images).all()):
        raise RuntimeError(f'bad images {tuple(images.shape)}')
    return launches, opt, train_step, 1e3 / steps_per_s


def profile_main_path(opt, train_step, crt, step_ms, steps=10):
    """torch.profiler (device events) over `steps` more steps of the main
    path: the device's busy share of a step and each kernel's share of
    the device time. The profiler slows the host, so the busy share is
    also given against the unprofiled step time `step_ms`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bhnerf_tpu_torch.train.optimizer import LogFn

    opt.num_iters = steps
    sync = LogFn(lambda o: float(o.loss))   # one step per synchronise
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.run(BATCH, train_step, crt, log_fns=[sync], verbose=False)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    # device rows only (host ops carry the time of what they launch); the
    # Adam range overlaps Adam's own kernels
    rows = [(e.key, e.self_device_time_total / 1e3 / steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and 'Optimizer.step' not in e.key]
    busy_ms = sum(ms for _, ms in rows)
    if busy_ms <= 0.0:
        raise RuntimeError('torch.profiler recorded no device time')
    log(f'profile: {steps} steps, device busy {busy_ms:.3f} ms per step = '
        f'{busy_ms / wall_ms:.3f} of the profiled {wall_ms:.3f} ms step, '
        f'{busy_ms / step_ms:.3f} of the unprofiled {step_ms:.3f} ms step '
        f'(idle {1 - busy_ms / step_ms:.3f})')
    for key, ms in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f'  {100 * ms / busy_ms:5.1f}% {ms:.3f} ms/step  {key[:90]}')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false); this script runs only on the GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from bhnerf_tpu_torch.ops import _build, fused

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)
    # the card's name and power limit, as nvidia-smi gives them
    log(card_info())
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}')

    t0 = time.perf_counter()
    fused._lib()
    log(f'build: fused_render.cu built and loaded in '
        f'{time.perf_counter() - t0:.1f} s')
    ptxas = _build.build_dir('fused_render') / 'fused_render.ptxas.log'
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            entry = re.search(r'(fused_render_[a-z_]+_kernel)(ILb1)?', line)
            if 'Compiling entry' in line and entry:
                log(f'  ptxas: {entry.group(1)}'
                    f'{" (bf16)" if entry.group(2) else ""}')
            elif 'registers' in line or 'spill' in line:
                log(f'  ptxas: {line.strip()}')

    predictor, crt, t_frames = host_precompute(device)
    kernels = kernel_checks(predictor, crt, t_frames, device)
    launches, opt, train_step, step_ms = train_main_path(
        predictor, crt, t_frames, device)
    profile_main_path(opt, train_step, crt, step_ms)
    for entry, count in zip(kernels, launches):
        entry['launches'] = count
        entry['launches_per_step'] = count / STEPS
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
