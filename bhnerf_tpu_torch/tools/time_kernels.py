"""Time builds of the fused render kernels against each other on one card.

Each variant is a CUDA source with optional nvcc defines, built for sm_90a
(all builds start together) and called through its C entry points at the
training step's shapes: nt = 6 frames, N = 68,352 samples, the 4x128 MLP
with posenc degree 3, inputs from a numpy seed. The variants are timed in
the given order (mean of --repeats launches by CUDA events), in f32 and
bf16, and checked against the plain version:

* `--kernel fwd`: `fused_render_fwd` with and without the stash (F, and
  the hidden activations H for a source whose forward takes `h_store`);
  emission and H held to atol 2e-6 / rtol 1e-4 and F to 1e-5 in f32
  (2e-3 / 2e-2 and one bf16 step in bf16; H as `stash_agrees` says). A
  source that exports `fused_render_fwd_scratch` takes the scratch buffer
  for its reordered weights and reports its occupancy; one that does not
  is called with the older signature.
* `--kernel bwd`: `fused_render_bwd` with and without the frame-time
  cotangent, on F, H and the emission from the forward's plain version
  and the cotangent of a squared error against a random target, on both
  paths: `recompute` (no H) and, for a source that takes `h_store`,
  `stash` (H read). Every call also zeroes its partials, as the wrapper
  does. Each variant's gradients are also compared bitwise with the first
  variant's on the same path.

    python -m bhnerf_tpu_torch.tools.time_kernels --kernel fwd \\
        --variant parent=path/to/old/fused_render.cu \\
        --variant new=bhnerf_tpu_torch/ops/csrc/fused_render.cu \\
        --order parent,new,new,parent

A build made with -DBWD_PHASE_TIMERS also reports the share of the
backward's cycles in each phase of a tile. Prints one line per timing
and, last, a JSON summary (also written to --out if given).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from bhnerf_tpu_torch.models.fields import NeRFPredictor
from bhnerf_tpu_torch.ops import _build, fused

NT, N, DEPTH, WIDTH, DEG, SCALE = 6, 68_352, 4, 128, 3, 8.0
CFG = (DEPTH, WIDTH, True)
BUILD = Path(__file__).resolve().parent.parent / '_build' / 'variants'


def build(variants):
    """Compile every variant at once; returns {name: (lib, ptxas lines)}."""
    procs = {}
    for name, (src, defines) in variants.items():
        out = BUILD / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defines, '-o',
             str(out / 'libfused_render.so'), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{err}')
        lib = ctypes.CDLL(str(BUILD / name / 'libfused_render.so'))
        # both kernels take the activation stash after F, and the forward
        # its weights' scratch before em, only in sources that have them
        lib.takes_acts = 'h_store' in variants[name][0].read_text()
        has_scratch = hasattr(lib, 'fused_render_fwd_scratch')
        lib.fused_render_bwd.argtypes = (
            fused.BWD_ARGTYPES if lib.takes_acts
            else fused.BWD_ARGTYPES[:3] + fused.BWD_ARGTYPES[4:])
        lib.fused_render_bwd.restype = fused._I
        if has_scratch:
            lib.fused_render_fwd_scratch.argtypes = [fused._I] * 4
            lib.fused_render_fwd_occupancy.argtypes = ([fused._I] * 5
                                                       + [fused._P] * 2)
        lib.fused_render_fwd.argtypes = (
            [fused._P] * (9 + has_scratch + lib.takes_acts)
            + fused.FWD_ARGTYPES[11:])
        lib.fused_render_fwd.restype = fused._I
        ptxas = [l.strip() for l in err.splitlines()
                 if 'registers' in l or 'spill' in l or 'Compiling' in l]
        libs[name] = (lib, ptxas)
    return libs


def make_inputs(device):
    rng = np.random.default_rng(0)
    put = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(
        device).contiguous()
    pred = NeRFPredictor(scale=SCALE, net_depth=DEPTH, net_width=WIDTH,
                         posenc_deg=DEG)
    params = pred.init_params(generator=torch.Generator().manual_seed(0),
                              device=device)
    weights = [w.detach() for w in fused.pack_params(params)[0]]
    biases = [b.detach() for b in fused.pack_params(params)[1]]
    biases[-1] = biases[-1] + 8.0          # macroscopic emission
    t_eff = put(rng.uniform(0, 50, (NT, 1)))
    coords = put(rng.uniform(-8, 8, (3, N)))
    omega = put(rng.uniform(0.01, 0.1, (1, N)))
    tg = put(rng.uniform(-30, 30, (1, N)))
    smask = put(rng.random((1, N)) > 0.2)
    target = put(rng.random((NT, N)))
    return weights, biases, t_eff, coords, omega, tg, smask, target


def runner(lib, dtype, want_dt, em, F, H, omega, g, weights, biases,
           device):
    """A wrapper-equivalent call of one build, reading the activations
    from H or, if None, recomputing them: returns fn() -> grads."""
    bf16 = dtype == 'bfloat16'
    feat = F.shape[0]
    w, b, n_params = fused._pack_cuda(weights, biases, CFG, feat, bf16)
    stride = -(-n_params // 8) * 8
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = min(sms, NT * (N // fused.TILE_N))
    partial = torch.empty((grid, stride), dtype=torch.float32, device=device)
    dt_partial = torch.empty((grid, NT), dtype=torch.float32, device=device)
    grads = torch.empty(n_params, dtype=torch.float32, device=device)
    d_t = torch.empty((NT, 1), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    acts = [fused._ptr(H)] if lib.takes_acts else []

    def fn():
        partial.zero_()
        dt_partial.zero_()
        err = lib.fused_render_bwd(
            g.data_ptr(), em.data_ptr(), F.data_ptr(), *acts,
            omega.data_ptr(), w.data_ptr(), b.data_ptr(), partial.data_ptr(),
            stride, dt_partial.data_ptr(), grads.data_ptr(), d_t.data_ptr(),
            NT, N, DEPTH, WIDTH, feat, 1, DEG, int(bf16), int(want_dt), grid,
            stream)
        _build.check(err, 'fused_render_bwd')
        return grads, d_t
    fn.grid = grid
    return fn


def fwd_runner(lib, dtype, stash, inputs, device):
    """A wrapper-equivalent forward call of one build: fn() -> (em, F, H),
    F and H None without the stash, H None for a build without one."""
    weights, biases, t_eff, coords, omega, tg, smask, _ = inputs
    bf16 = dtype == 'bfloat16'
    feat = 3 * (1 + 2 * DEG)
    w, b, _ = fused._pack_cuda(weights, biases, CFG, feat, bf16)
    em = torch.empty((NT, N), dtype=torch.float32, device=device)
    F = (torch.empty((feat, NT * N), dtype=torch.float32, device=device)
         if stash else None)
    H = (torch.empty((DEPTH, WIDTH, NT * N), dtype=torch.float32,
                     device=device) if stash and lib.takes_acts else None)
    acts = [fused._ptr(H)] if lib.takes_acts else []
    wf = None
    if hasattr(lib, 'fused_render_fwd_scratch'):
        wf = torch.empty(lib.fused_render_fwd_scratch(DEPTH, WIDTH, feat, 1),
                         dtype=torch.float32, device=device)
    scratch = [] if wf is None else [wf.data_ptr()]
    stream = torch.cuda.current_stream(device).cuda_stream

    def fn():
        err = lib.fused_render_fwd(
            t_eff.data_ptr(), coords.data_ptr(), omega.data_ptr(),
            tg.data_ptr(), smask.data_ptr(), w.data_ptr(), b.data_ptr(),
            *scratch, em.data_ptr(), fused._ptr(F), *acts, NT, N, DEPTH,
            WIDTH, feat, 1, DEG, float(np.float32(1.0 / SCALE)), int(bf16),
            stream)
        _build.check(err, 'fused_render_fwd')
        return em, F, H
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fn.grid = min(sms, -(-NT * N // 128))
    fn.scratch = wf                 # lives as long as the calls
    return fn


def stash_agrees(h_kernel, h_plain, compute_dtype):
    """(max abs difference, share of values outside the emission's
    tolerance, whether the kernel's activation stash agrees with the plain
    forward's): atol 2e-6 / rtol 1e-4 in f32. In bf16 a value on a
    rounding boundary may round to the neighbouring bf16 value in one
    version and not the other, and the layers after it carry that
    difference on, so all but 1e-4 of the values are held to the
    emission's atol 2e-3 / rtol 2e-2, and every value to 2e-2 of the
    stash's largest magnitude."""
    diff = (h_kernel - h_plain).abs()
    err = float(diff.max())
    if compute_dtype == 'float32':
        ok = torch.allclose(h_kernel, h_plain, atol=2e-6, rtol=1e-4)
        return err, float(not ok), bool(ok)
    share = float((diff > 2e-3 + 2e-2 * h_plain.abs()).float().mean())
    largest = float(h_plain.abs().max())
    return err, share, bool(share < 1e-4 and err <= 2e-2 * largest)


def occupancy(lib, bf16):
    """(blocks per SM, threads per block) of a build's forward, or None
    for a source without the query."""
    if not hasattr(lib, 'fused_render_fwd_occupancy'):
        return None
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    _build.check(lib.fused_render_fwd_occupancy(
        DEPTH, WIDTH, 3 * (1 + 2 * DEG), 1, int(bf16), ctypes.byref(blocks),
        ctypes.byref(threads)), 'fused_render_fwd_occupancy')
    return blocks.value, threads.value


def time_forward(libs, order, repeats, inputs, device):
    weights, biases, t_eff, coords, omega, tg, smask, _ = inputs
    results = []
    for name, (lib, _) in libs.items():
        for bf16 in (False, True):
            occ = occupancy(lib, bf16)
            if occ is not None:
                print(f'{name} forward {"bf16" if bf16 else "f32"}: '
                      f'{occ[0]} block(s) of {occ[1]} threads per SM = '
                      f'{occ[0] * occ[1] // 32} warps', flush=True)
    for dtype in ('float32', 'bfloat16'):
        em_p, f_p, h_p = fused.render_fwd_plain(
            t_eff, coords, omega, tg, smask, weights, biases, CFG, SCALE,
            DEG, dtype, stash=True)
        # bf16: a value on a rounding boundary may round to the neighbouring
        # bf16 value in one version and not the other
        tol = (dict(atol=2e-6, rtol=1e-4), 1e-5) if dtype == 'float32' \
            else (dict(atol=2e-3, rtol=2e-2), 2.0 ** -7)
        for stash in (False, True):
            fns = {name: fwd_runner(lib, dtype, stash, inputs, device)
                   for name, (lib, _) in libs.items()}
            checks = {}
            for name, fn in fns.items():
                em, F, H = fn()
                torch.cuda.synchronize()
                em_err = float((em - em_p).abs().max())
                f_err = float((F - f_p).abs().max()) if stash else None
                h_err, _, h_ok = stash_agrees(H, h_p, dtype) \
                    if H is not None else (None, 0.0, True)
                ok = torch.allclose(em, em_p, **tol[0]) and h_ok and \
                    (f_err is None or f_err <= tol[1])
                checks[name] = (em_err, f_err, h_err, ok)
            for name in order:
                ms = cuda_ms(fns[name], repeats)
                em_err, f_err, h_err, ok = checks[name]
                row = dict(kernel='fwd', variant=name, dtype=dtype,
                           stash=stash, acts=h_err is not None, ms=ms,
                           em_err=em_err, f_err=f_err, h_err=h_err, ok=ok)
                share = phase_split(libs[name][0], fns[name], 'fwd')
                if share is not None:
                    row['phase_share'] = share
                results.append(row)
                print(f'fwd {dtype} stash={stash} {name}: {ms:.3f} ms, '
                      f'max|em - plain| {em_err:.3e}, features {f_err}, '
                      f'activations {h_err} ({"ok" if ok else "FAIL"})',
                      flush=True)
    return results


PHASES = ('feature load', 'recompute or stash wait', 'head',
          'masks + bias sums',
          'weight grads + products back', 'frame-time cotangent')


FWD_PHASES = ('prologue', 'waiting for weights', 'products',
              'bias/ReLU stores + layer barrier', 'head')


def phase_split(lib, fn, kernel='bwd'):
    """Each phase's share of the cycles of one launch of a build made with
    -DBWD_PHASE_TIMERS (or -DFWD_PHASE_TIMERS for the forward), summed
    over blocks, as {phase: share}; None for other builds."""
    phases = PHASES if kernel == 'bwd' else FWD_PHASES
    try:
        get = getattr(lib, f'fused_render_{kernel}_phases')
    except AttributeError:
        return None
    fn()
    torch.cuda.synchronize()
    out = np.zeros((fn.grid, len(phases)), np.int64)
    get.argtypes = [ctypes.c_void_p, ctypes.c_int]
    get.restype = ctypes.c_int
    _build.check(get(out.ctypes.data, fn.grid),
                 f'fused_render_{kernel}_phases')
    cycles = out.sum(axis=0)
    share = dict(zip(phases, (cycles / cycles.sum()).tolist()))
    print(f'  phases ({out.sum(axis=1).max()} cycles in the longest block): '
          + ', '.join(f'{p} {100 * x:.1f}%' for p, x in share.items()),
          flush=True)
    return share


def unpack(grads, weights, biases):
    out, off = [], 0
    for wi in weights:
        o, k = wi.shape
        kp = fused._pad16(k)
        out.append(grads[off:off + o * kp].view(o, kp)[:, :k])
        off += o * kp
    for bi in biases:
        out.append(grads[off:off + bi.numel()])
        off += bi.numel()
    return out


def cuda_ms(fn, repeats):
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


def time_backward(libs, order, repeats, inputs, device):
    weights, biases, t_eff, coords, omega, tg, smask, target = inputs
    results = []
    for dtype in ('float32', 'bfloat16'):
        em, F, H = fused.render_fwd_plain(t_eff, coords, omega, tg, smask,
                                          weights, biases, CFG, SCALE, DEG,
                                          dtype, stash=True)
        g = (2.0 * (em - target)).contiguous()   # a squared-error loss
        for want_dt, path in ((False, 'recompute'), (False, 'stash'),
                              (True, 'recompute'), (True, 'stash')):
            gp = fused.render_bwd_plain(g, em, F, omega, weights, biases,
                                        CFG, DEG, dtype, want_dt)
            ref = gp[0] + gp[1]
            acts = H if path == 'stash' else None
            fns = {name: runner(lib, dtype, want_dt, em, F, acts, omega, g,
                                weights, biases, device)
                   for name, (lib, _) in libs.items()
                   if path == 'recompute' or lib.takes_acts}
            checks, first = {}, None
            for name, fn in fns.items():
                grads, d_t = fn()
                torch.cuda.synchronize()
                got = unpack(grads, weights, biases)
                norm = max(float((a - b).abs().max() / (a.abs().max() + 1e-8))
                           for a, b in zip(ref, got))
                dt_rel = (float(((d_t - gp[2]).abs()
                                 / (gp[2].abs() + 1e-12)).max())
                          if want_dt else None)
                if first is None:
                    first = (grads.clone(), d_t.clone())
                same = torch.equal(grads, first[0]) and \
                    (not want_dt or torch.equal(d_t, first[1]))
                checks[name] = (norm, dt_rel, same)
            for name in (v for v in order if v in fns):
                ms = cuda_ms(fns[name], repeats)
                norm, dt_rel, same = checks[name]
                row = dict(kernel='bwd', variant=name, dtype=dtype,
                           want_dt=want_dt, path=path, ms=ms, norm_err=norm,
                           dt_rel_err=dt_rel, bitwise_as_first=same)
                share = phase_split(libs[name][0], fns[name])
                if share is not None:
                    row['phase_share'] = share
                results.append(row)
                print(f'bwd {dtype} want_dt={want_dt} {path} {name}: '
                      f'{ms:.3f} ms, '
                      f'normalised err {norm:.3e}, d_t rel err {dt_rel}, '
                      f'bitwise as the first variant: {same}', flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--kernel', choices=('fwd', 'bwd'), default='bwd')
    ap.add_argument('--variant', action='append', required=True,
                    help='name=source.cu[:-DNAME=VALUE,...]')
    ap.add_argument('--order', required=True,
                    help='comma-separated variant names, timed in turn')
    ap.add_argument('--repeats', type=int, default=50)
    ap.add_argument('--out', help='also write the JSON summary here')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('time_kernels: needs a CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda', 0)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    variants = {}
    for spec in args.variant:
        name, rest = spec.split('=', 1)
        src, _, defs = rest.partition(':')
        variants[name] = (Path(src), [d for d in defs.split(',') if d])
    order = args.order.split(',')
    libs = build(variants)
    for name, (_, ptxas) in libs.items():
        for line in ptxas:
            print(f'{name} ptxas: {line}', flush=True)

    time_fn = time_forward if args.kernel == 'fwd' else time_backward
    results = time_fn(libs, order, args.repeats, make_inputs(device), device)
    summary = dict(card=card, kernel=args.kernel, repeats=args.repeats,
                   nt=NT, n=N,
                   variants={k: [str(v[0]), v[1]] for k, v in
                             variants.items()},
                   ptxas={k: v[1] for k, v in libs.items()}, results=results)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0 if all(r.get('ok', True) for r in results) else 1


if __name__ == '__main__':
    sys.exit(main())
