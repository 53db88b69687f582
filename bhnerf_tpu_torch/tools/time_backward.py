"""Time builds of the fused render backward against each other on one card.

Each variant is a CUDA source with optional nvcc defines, built for sm_90a
(all builds start together) and called through its C entry point
`fused_render_bwd` at the training step's shapes: nt = 6 frames, N =
68,352 samples, the 4x128 MLP with posenc degree 3, inputs from a numpy
seed, F and the emission from the forward's plain version, the
cotangent of a squared error against a random target. Every call
also zeroes its partials, as the wrapper does. For f32 and bf16, with and
without the frame-time cotangent, the variants are timed in the given
order (mean of --repeats launches by CUDA events) and checked against the
plain version.

    python -m bhnerf_tpu_torch.tools.time_backward \\
        --variant parent=path/to/old/fused_render.cu \\
        --variant new=bhnerf_tpu_torch/ops/csrc/fused_render.cu \\
        --variant timed=bhnerf_tpu_torch/ops/csrc/fused_render.cu:-DBWD_PHASE_TIMERS \\
        --order parent,new,timed,new,parent

A build made with -DBWD_PHASE_TIMERS also reports the share of the
kernel's cycles in each phase of a tile. Prints one line per timing and,
last, a JSON summary (also written to --out if given).
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

NT, N, DEPTH, WIDTH, DEG = 6, 68_352, 4, 128, 3
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
        lib.fused_render_bwd.argtypes = ([fused._P] * 7 + [fused._I]
                                         + [fused._P] * 3 + [fused._I] * 10
                                         + [fused._P])
        lib.fused_render_bwd.restype = fused._I
        ptxas = [l.strip() for l in err.splitlines()
                 if 'registers' in l or 'spill' in l]
        libs[name] = (lib, ptxas)
    return libs


def make_inputs(device):
    rng = np.random.default_rng(0)
    put = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(
        device).contiguous()
    pred = NeRFPredictor(scale=8.0, net_depth=DEPTH, net_width=WIDTH,
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


def runner(lib, dtype, want_dt, em, F, omega, g, weights, biases, device):
    """A wrapper-equivalent call of one build: returns fn() -> grads."""
    bf16 = dtype == 'bfloat16'
    cfg = (DEPTH, WIDTH, True)
    feat = F.shape[0]
    w, b, n_params = fused._pack_cuda(weights, biases, cfg, feat, bf16)
    stride = -(-n_params // 8) * 8
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = min(sms, NT * (N // fused.TILE_N))
    partial = torch.empty((grid, stride), dtype=torch.float32, device=device)
    dt_partial = torch.empty((grid, NT), dtype=torch.float32, device=device)
    grads = torch.empty(n_params, dtype=torch.float32, device=device)
    d_t = torch.empty((NT, 1), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def fn():
        partial.zero_()
        dt_partial.zero_()
        err = lib.fused_render_bwd(
            g.data_ptr(), em.data_ptr(), F.data_ptr(), omega.data_ptr(),
            w.data_ptr(), b.data_ptr(), partial.data_ptr(), stride,
            dt_partial.data_ptr(), grads.data_ptr(), d_t.data_ptr(), NT, N,
            DEPTH, WIDTH, feat, 1, DEG, int(bf16), int(want_dt), grid,
            stream)
        _build.check(err, 'fused_render_bwd')
        return grads, d_t
    fn.grid = grid
    return fn


PHASES = ('feature load', 'recompute', 'head', 'masks + bias sums',
          'weight grads + products back', 'frame-time cotangent')


def phase_split(lib, fn):
    """Cycles per phase of one launch of a build made with
    -DBWD_PHASE_TIMERS (summed over blocks), or None for other builds."""
    try:
        get = lib.fused_render_bwd_phases
    except AttributeError:
        return None
    fn()
    torch.cuda.synchronize()
    out = np.zeros((fn.grid, len(PHASES)), np.int64)
    get.argtypes = [ctypes.c_void_p, ctypes.c_int]
    get.restype = ctypes.c_int
    _build.check(get(out.ctypes.data, fn.grid), 'fused_render_bwd_phases')
    return out.sum(axis=0)


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--variant', action='append', required=True,
                    help='name=source.cu[:-DNAME=VALUE,...]')
    ap.add_argument('--order', required=True,
                    help='comma-separated variant names, timed in turn')
    ap.add_argument('--repeats', type=int, default=50)
    ap.add_argument('--out', help='also write the JSON summary here')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('time_backward: needs a CUDA device', file=sys.stderr)
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

    weights, biases, t_eff, coords, omega, tg, smask, target = \
        make_inputs(device)
    results = []
    for dtype in ('float32', 'bfloat16'):
        em, F = fused.render_fwd_plain(t_eff, coords, omega, tg, smask,
                                       weights, biases, (DEPTH, WIDTH, True),
                                       8.0, DEG, dtype, stash=True)
        g = (2.0 * (em - target)).contiguous()   # a squared-error loss
        for want_dt in (False, True):
            gp = fused.render_bwd_plain(g, em, F, omega, weights, biases,
                                        (DEPTH, WIDTH, True), DEG, dtype,
                                        want_dt)
            ref = gp[0] + gp[1]
            fns = {name: runner(lib, dtype, want_dt, em, F, omega, g,
                                weights, biases, device)
                   for name, (lib, _) in libs.items()}
            checks = {}
            for name, fn in fns.items():
                grads, d_t = fn()
                torch.cuda.synchronize()
                got = unpack(grads, weights, biases)
                norm = max(float((a - b).abs().max() / (a.abs().max() + 1e-8))
                           for a, b in zip(ref, got))
                dt_rel = (float(((d_t - gp[2]).abs()
                                 / (gp[2].abs() + 1e-12)).max())
                          if want_dt else None)
                checks[name] = (norm, dt_rel)
            for name in order:
                ms = cuda_ms(fns[name], args.repeats)
                norm, dt_rel = checks[name]
                row = dict(variant=name, dtype=dtype, want_dt=want_dt,
                           ms=ms, norm_err=norm, dt_rel_err=dt_rel)
                cycles = phase_split(libs[name][0], fns[name])
                if cycles is not None:
                    share = cycles / cycles.sum()
                    row['phase_share'] = dict(zip(PHASES, share.tolist()))
                    print(f'  {name} phases: ' + ', '.join(
                        f'{p} {100 * x:.1f}%' for p, x in zip(PHASES, share)),
                        flush=True)
                results.append(row)
                print(f'{dtype} want_dt={want_dt} {name}: {ms:.3f} ms, '
                      f'normalised err {norm:.3e}, d_t rel err {dt_rel}',
                      flush=True)
    summary = dict(card=card, repeats=args.repeats, nt=NT, n=N,
                   variants={k: [str(v[0]), v[1]] for k, v in
                             variants.items()},
                   ptxas={k: v[1] for k, v in libs.items()}, results=results)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
