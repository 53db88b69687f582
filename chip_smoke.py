"""GPU smoke run of bhnerf_tpu_torch: build the kernels, hold them against
their plain versions at the shapes of the training paths, train a few
steps of the Tutorial-3 image fit and of the ALMA polarized-lightcurve fit
at full width, recover a synthetic hotspot from its movie in 1000 steps
(per step and in chunks) and from an ngEHT observation in 5000, run
the ALMA fit script's sweep, trace geodesic tables on the card with
the float32 tracer kernel, run equatorial lensing and the
synthetic-flare workflow on it, run the multi-GPU support as two
ranks sharing the one CUDA device, run the tutorials and the last
examples, and run the reference's benchmark (bhnerf_tpu_torch.bench).

Run from the repository root on a machine with an NVIDIA Hopper GPU and
nvcc:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles csrc/*.cu for sm_90a (one nvcc a source, in
     parallel) and prints the build seconds and ptxas's registers;
  3. host precompute: f64 geodesics (64x64 rays x 100 samples, a table
     the recovery phase reuses), ray constants, domain compaction (the
     'gather' layout);
  4. kernels vs plain versions at the compacted sample count N and a
     6-frame batch: forward in f32 and bf16 (with and without the stash,
     and at a sample count that is no multiple of its 128-column tile),
     its occupancy, backward with and without the frame-time cotangent;
     max errors and milliseconds of both;
  5. main path: TrainStep.image(fused=True) + Optimizer.run for 20 steps
     of batch 6 on the card, with launch counters proving that every step
     went through both kernels, finite and decreasing losses, steps/s;
  6. torch.profiler over 10 more steps: the device's busy share of a step
     and each kernel's share of the device time;
  7. the ALMA polarized-lightcurve fit (the model block of
     scripts/fit_alma_lp_apr11_sgra_flare.yaml at inclination 60 deg,
     Stokes I, Q, U, a sub-pixel ensemble of 4 ray tables):
     alma.get_raytracing_args on the host, compact_ensemble_args in the
     'gather' and 'native' layouts, both kernels against their plain
     versions at the 'native' sample count (exact zeros on its filler
     columns, nothing taken from them by the backward), 20 steps of the
     'lc' loss with lr_inject in each layout (one forward and one
     backward launch per step, a falling test loss, every variant drawn),
     a test step over the ensemble, the polarized 'full' image loss
     through the 'native' reduce against the segment sum and 20 steps of
     it in each layout, the cost of the aux-image reduce, and a profile
     of 10 ALMA steps per layout; then ALMA_SCAN_STEPS 'lc' steps on the
     'gather' ensemble in chunks of ALMA_SCAN_CHUNK (Optimizer.run
     scan_chunk) against the per-step loop from the same seed, whose
     loss series they must give to float32 round-off;
  8. the recovery fit of bench_recovery.py on the Tutorial-3 geometry's
     table: a hotspot at 1.1 r_isco rendered into a 64-frame movie by
     emission.image_plane_dynamics on the card (and the device memory a
     render chunk takes per sample and frame), then 1000 steps of the
     'full' image fit (rmin 0, batch 6, lr 1e-3 -> 1e-5) in float32 and in
     bfloat16, each held to the bar of RECOVERY_MIN_PSNR dB of psnr_3d
     (sample_3d_grid at 64^3 against the hotspot) and
     RECOVERY_MAX_LC_ERR_PCT of lc_err_pct, with one forward and one
     backward launch per step; the float32 fit checkpoints every 500
     steps, and restore_params, a resumed Optimizer and keep pruning are
     checked against it; the bfloat16 fit once more in chunks of
     RECOVERY_SCAN_CHUNK through bhnerf_tpu_torch.bench_recovery.main()
     (its warm-up chunk first), the first chunk of its timed fit under
     torch.cuda.set_sync_debug_mode('error'), held to the same bar and
     launch counts, with steps/s and device idle share beside the
     per-step fit's; both kernels against their plain versions at the
     fit's sample count in float32 and in bfloat16;
  9. the fit script's sweep (bhnerf_tpu_torch.scripts.
     fit_alma_lp_apr11_sgra_flare.run_sweep) on a synthetic observation
     at the configuration's full width: FIT_INCS x one seed of FIT_STEPS
     chunked steps with the four LogFns recorded by MemoryWriter; both
     kernels against their plain versions in float32 on each
     inclination's compacted table, at the training batch and at the
     20-frame batch of the datafit renders; alma.chi2_df over the
     inclinations at step FIT_STEPS (finite, one value per cell) from
     host tables and, beside it, chi2_df(backend='device') from tables of
     the tracer kernel (one launch an inclination), both values and both
     seconds printed; then one run resumed to FIT_RESUME_STEPS (it must
     continue from FIT_STEPS);
  10. the EHT visibility path: bench_recovery.main(EHT_STEPS, eht=True)
     (bench_recovery.py --eht): the same hotspot's
     movie over the ngEHT window 4.0-15.5 UT rendered on the card and
     observed by the ngEHT array with thermal noise (observe_same), then
     TrainStep.eht('vis', dense) for EHT_STEPS bfloat16 steps at npix 64
     in chunks of EHT_SCAN_CHUNK, held to the bar of EHT_MIN_PSNR dB and
     EHT_MAX_LC_ERR_PCT, with nvis, the bytes of the operator on the card
     and a profile; then a 128x128
     table from the host tracer, both kernels against their plain
     versions at its sample count over the EHT window in float32 and
     bfloat16, the dense and the factored operator against each other on
     one batch, and EHT_OPERATOR_STEPS float32 steps of each with a
     profile;
  11. the float32 device tracer (trace_geodesics(backend='device'), the
     kernel of ops/csrc/geodesic_trace.cu): the kernel against its plain
     version on the card at TRACE_CHECK_RAYS^2 rays x 100 samples of spin
     0.94 at TRACE_CHECK_N_FINE fine steps and on the ALMA ensemble's inputs
     at its fine steps (the drive's gate, median |dt|, the same
     terminal Mino time on >= 95% of the rays); the float32 tables against
     the host float64 ones of the earlier phases (the Tutorial-3 table; the
     four ALMA tables, traced by get_raytracing_args(backend='device') in
     one launch from the same seed, on the same screens) and in the drive
     (bhnerf_tpu_torch.scripts.drive_device_geos, its own host table, at
     N_FINE); the hotspot lightcurve from the device table within 1% of the
     host one; 20 ALMA 'lc' steps on the device-traced ensemble; the
     kernel's ms at 64x64 (n_fine 8192), 128x128 and the ensemble, with its
     bound and the time of its longest ray alone, and the wall seconds of
     the traces and of get_raytracing_args against the host's;
  12. synthetic sources and equatorial lensing (lines starting
     `synthetic`): rho_of_req(0, 20 deg, 6 M) at the reference's sizes
     (64 azimuths, 40 bisection steps, 400 samples, n_fine 8192) on the
     device tracer in exactly 42 launches, every root found and its ray
     crossing within 1e-2 req of req on the host float64 trace; the
     mbar = 1 ring within 0.35 M of sqrt(27) at 0.01 deg; Gelles2021's
     face-on checks on the device tracer; equatorial_ring on the
     Tutorial-3 device table against the host one, every ray whose
     crossing sample differs explained (ring_differences); then
     generate_synthetic_lightcurves at its defaults (64x64x100, 123
     frames, fov 40 M, 60 deg) for SYNTH_SOURCES, their one screen traced
     once at N_FINE (memo_traces), rendered on the card,
     fit_synthetic_lp_flares' sweep on the hotspot at its configuration
     (4x128, Q/U 'lc', batch 6, fused, chunks of 500) over SYNTH_INCS x
     one seed cut to SYNTH_STEPS steps with MemoryWriter (launch counts,
     a falling loss, the psnr against the flare), both kernels against
     their plain versions at its shapes in float32,
     chi2_df(backend='device') over its checkpoints (one launch an
     inclination), and the chi^2 example's small mode on the device
     tracer.
  13. the ALMA production drive (lines starting `production`):
     bhnerf_tpu_torch.scripts.drive_alma_production at full width (64x64
     rays x 100 samples, 4x128, batch 6, chunks of 500) cut to PROD_STEPS
     steps and a PROD_ENSEMBLE-variant ensemble with its host tables at
     PROD_N_FINE: leg 1 in a child process stopped by SIGTERM after its
     first periodic checkpoint, leg 2 resumed from that step to
     PROD_STEPS through the fit's --resume, finite train and validation
     chi^2 over a fresh ensemble, one forward and one backward launch a
     training
     step (the children print their counts); both kernels against their
     plain versions in float32 at the fit's N.
  14. multi-GPU (lines starting `multigpu`; multigpu_phase): two ranks
     of bhnerf_tpu_torch.scripts.drive_multigpu on this card over gloo
     against this process on the same inputs: the sharded device traces
     of the Tutorial-3 screen and the ALMA ensemble (bitwise), one
     Tutorial-3 step under meshes (1, 2) and (2, 1) and 200 chunked
     steps under each, an ALMA 'lc' step under (1, 2), rank-0
     checkpoints, each rank's kernel launches and collectives; then one
     rank over NCCL.
  15. the tutorials and the last examples (lines starting `tutorials`;
     tutorials_phase): the five tutorials of bhnerf_tpu_torch.tutorials
     and the examples recovery_animation and selfcal_known_corruption at
     full width in this process, their host tables at N_FINE, one a
     screen: tutorial 3's plain-path recovery held to RECOVERY_MIN_PSNR,
     tutorial 4's EHT losses (TUTORIAL4_STEPS of them) finite and
     falling, tutorial 5's render
     of tutorial 3's checkpoint, recovery_animation's 1000 fused steps
     (one backward launch a step) and its 24 views, the exact
     self-calibration; both kernels against their plain versions at
     recovery_animation's N; both volume compositors at the tutorials'
     full shapes against the CPU, with their ms and peak device memory.
  16. the benches (lines starting `bench`; bench_phase): every section of
     bhnerf_tpu_torch.bench at full width with BENCH_REPS=1 on the
     Tutorial-3 table, the fused launch counts set to 0 before and read
     after (one forward and one backward a fused step), the reference's
     keys of its line none null; both kernels against their plain versions
     in float32 and bfloat16 at the ALMA shape's N.
The ten lines before the last are the JSON recovery, chunked-loop, EHT,
device-trace, synthetic, production, multi-GPU, tutorials and bench
summaries and the JSON kernel summary; the last line is {"ok": true,
"device": {...}}.
"""
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NUM_RAYS = 64           # rays per image side
NGEO = 100              # samples per ray
N_FINE = 4096           # pass-1 fine steps of the geodesic tracer
NT = 64                 # movie frames
BATCH = 6               # frames per step
FOV = 16.0
SPIN = 0.2
STEPS = 20
REPEATS = 20            # launches per timing
ALMA_RAYS = 4           # sub-pixel ray tables in the ALMA ensemble
ALMA_SIGMA = (0.15, 1e-2, 1e-2)
# the model block of scripts/fit_alma_lp_apr11_sgra_flare.yaml, with the
# tracer's fine steps as in the Tutorial-3 phase
ALMA_MODEL = {
    'spin': 0.0, 'fov_M': 40.0, 'z_width': 4, 'rmin': 'ISCO',
    'Q_frac': 0.85, 'b_consts': {'arad': 0, 'avert': 1, 'ator': 0},
    'Omega_dir': 'cw', 'Omega_frac': 1.0, 'num_alpha': NUM_RAYS,
    'num_beta': NUM_RAYS, 't_start_obs': 9.34056333326589,
    'ngeo': NGEO, 'n_fine': N_FINE}
# the recovery fit of bench_recovery.py:75-183: 1000 iterations of batch
# BATCH over NT frames of an hour, a hotspot and evaluation grid of
# RECOVERY_RES^3, checkpoints every RECOVERY_SAVE_PERIOD steps in float32
RECOVERY_STEPS = 1000
RECOVERY_RES = 64
RECOVERY_SAVE_PERIOD = 500
# the bar, set before the first run on the card (PERF.md): the reference
# reached 62.91 dB and 0.0883% in bfloat16 (RECOVERY.json); a field of
# zeros scores 33.1 dB against this hotspot
RECOVERY_MIN_PSNR = 55.0
RECOVERY_MAX_LC_ERR_PCT = 0.5
# the chunked loop of bench_recovery.py:143-168 (scan_chunk 500), and of
# the ALMA 'lc' fit on the 4-variant ensemble (ALMA_SCAN_STEPS steps in
# chunks of ALMA_SCAN_CHUNK against the per-step loop from the same seed)
RECOVERY_SCAN_CHUNK = 500
ALMA_SCAN_STEPS = 200
ALMA_SCAN_CHUNK = 100
# the fit script's sweep (scripts/fit_alma_lp_apr11_sgra_flare.yaml at its
# full width) on a synthetic observation, cut to FIT_INCS x one seed of
# FIT_STEPS steps in chunks, logs and checkpoints of FIT_PERIOD steps,
# then one run resumed to FIT_RESUME_STEPS
FIT_INCS = (40.0, 60.0)
FIT_SEED = 4
FIT_STEPS = 500
FIT_PERIOD = 250
FIT_RESUME_STEPS = 750
# the EHT fit of bench_recovery.py --eht (:76-133, 144-183): the recovery
# hotspot observed by the ngEHT array in NT scans of EHT_TINT seconds over
# 4.0-15.5 UT, fitted to its complex visibilities
EHT_STEPS = 5000
EHT_SCAN_CHUNK = 500            # bench_recovery.py's chunks (:143-168)
EHT_TINT = 30.0
EHT_NPIX_PRODUCTION = 128       # the image size of the factored operator
EHT_OPERATOR_STEPS = 100        # steps of each operator at that size
# the bar, set before the first run on the card (PERF.md): the reference
# reached 52.5 dB and 0.215% in bfloat16 at npix 64 with the dense
# operator (RECOVERY.json); BASELINE.md asks for < 1% lightcurve error
EHT_MIN_PSNR = 45.0
EHT_MAX_LC_ERR_PCT = 1.0
# published dense peaks of one H100 SXM (NVIDIA's data sheet): TF32 tensor
# cores, FP32 outside the tensor cores, and HBM3
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# the device tracer against its plain version (a float32 loop of torch ops
# that launches ~450 kernels an RK4 step): TRACE_CHECK_RAYS^2 rays of the
# drive's geometry at TRACE_CHECK_N_FINE fine steps keep that loop short
# (its time goes with the fine steps, not the rays); the ALMA ensemble's
# check runs at the ensemble's own fine steps, the main path's
TRACE_CHECK_RAYS = 32
TRACE_CHECK_N_FINE = 1024
# the synthetic phase: the generator's sources at its defaults, then the
# synthetic fit's sweep at its configuration, cut to SYNTH_STEPS steps
SYNTH_SOURCES = ('hotspot', 'tube')
SYNTH_INCS = (40.0, 60.0)
SYNTH_STEPS = 500
# the production phase: the ALMA production drive at full width (64x64
# rays x 100 samples, 4x128, batch 6, chunks of 500), cut to PROD_STEPS
# steps (a checkpoint every 500, SIGTERM after the first), its ensemble
# from 10 sub-pixel variants to PROD_ENSEMBLE (the drive's legs and its
# evaluation each trace one host table a variant: 12 tables, not 30) and
# its tables to PROD_N_FINE fine steps (below 512 a table costs no less:
# its second pass and the physics dominate)
PROD_STEPS = 1500
PROD_ENSEMBLE = 4
PROD_N_FINE = 512
# tutorial 4's plain EHT fit, cut from its 2000 steps (~32 ms each)
TUTORIAL4_STEPS = 500
# float32 operations of one RK4 step of the tracer (ops/csrc/
# geodesic_trace.cu), each division counted as one: four right-hand sides
# of 40 operations and 4 divisions, 24 stage updates, the step h/6 and
# h/2, 36 for the weighted sums, 4 for Kahan's sum, 5 state updates
RK4_OPS = 247


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
    """The Tutorial-3 geometry's geodesic table and the main path's
    compacted ray constants. Returns (geos, predictor, crt, t_frames, the
    seconds of the host trace)."""
    from bhnerf_tpu_torch import constants, units
    from bhnerf_tpu_torch.geodesics import image_plane_geos
    from bhnerf_tpu_torch.models.fields import NeRFPredictor
    from bhnerf_tpu_torch.train.step import (compact_raytracing_args,
                                             raytracing_args)
    t0 = time.perf_counter()
    geos = image_plane_geos(spin=SPIN, inclination=np.deg2rad(60.0),
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
    return geos, predictor, crt, t_frames, t_geo


def kernel_inputs(predictor, crt, t_frames, rng, device, batch=BATCH):
    """The arguments render_fwd takes on the training path for a batch of
    `batch` frames drawn from `rng` over the compact samples `crt`, with
    seeded weights whose head bias is lifted so that emissions and
    gradients are macroscopic."""
    import torch
    from bhnerf_tpu_torch.ops import fused

    cfg = (predictor.net_depth, predictor.net_width, predictor.do_skip)
    params = predictor.init_params(
        generator=torch.Generator().manual_seed(0), device=device)
    weights = [w.detach() for w in fused.pack_params(params)[0]]
    biases = [b.detach() for b in fused.pack_params(params)[1]]
    biases[-1] = biases[-1] + 8.0
    t_frames_M = crt.frame_times_M(torch.as_tensor(
        t_frames[rng.choice(len(t_frames), batch, replace=False)],
        device=device))
    coords, omega, tg, smask, _ = fused._flatten_sample_args(
        crt.coords, crt.Omega, crt.t_geos_rel, 1.0, crt.coords.shape[1])
    t_eff = (t_frames_M.reshape(-1, 1) - crt.t_injection).contiguous()
    return (t_eff, coords, omega, tg, smask, weights, biases, cfg,
            predictor.scale, predictor.posenc_deg)


def grad_errors(plain, kernel):
    """(max abs, max normalised) difference over the gradient leaves of
    two render_bwd results."""
    err, norm_err = 0.0, 0.0
    for a, b in zip(plain[0] + plain[1], kernel[0] + kernel[1]):
        err = max(err, float((a - b).abs().max()))
        norm_err = max(norm_err, float((a - b).abs().max()
                                       / (a.abs().max() + 1e-8)))
    return err, norm_err


def kernel_checks(predictor, crt, t_frames, device):
    """Both kernels against their plain versions on the card at the main
    path's shapes. Returns the JSON entries (launches filled in later)."""
    import ctypes

    import torch
    from bhnerf_tpu_torch.ops import _build, fused

    rng = np.random.default_rng(0)
    n = crt.coords.shape[1]
    common = kernel_inputs(predictor, crt, t_frames, rng, device)
    t_eff, coords, omega, tg, smask, weights, biases, cfg, _, deg = common

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
        err, norm_err = grad_errors(gp, gk)
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


# device rows of a profile by what they belong to (substrings of the
# kernel names)
PROFILE_GROUPS = (
    ('forward kernel', ('fused_render_fwd',)),
    ('backward kernel', ('fused_render_bwd', 'fused_render_reduce')),
    ('matmul', ('gemm', 'gemv', 'cutlass', 'cublas')),
    ('per-pixel reduce', ('index', 'gather', 'scatter')))


def profile_path(label, opt, train_step, crt, step_ms, steps=10,
                 scan_chunk=0):
    """torch.profiler (device events) over `steps` more steps of a
    training path, after two warm-up steps that the profiler drops (with
    scan_chunk: one chunk of `steps` steps, after a warm-up chunk): the
    device's busy share of a step and each kernel's share of the device
    time. The profiler slows the host, so the busy share is also given
    against the unprofiled step time `step_ms`. Returns the device's busy
    milliseconds per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from bhnerf_tpu_torch.train.optimizer import LogFn

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if scan_chunk:
        opt.num_iters = steps
        opt.run(BATCH, train_step, crt, verbose=False, scan_chunk=steps)
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            opt.run(BATCH, train_step, crt, verbose=False, scan_chunk=steps)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    else:
        warmup = 2
        opt.num_iters = warmup + steps
        stamps = []

        def tick(o):
            float(o.loss)                   # one step per synchronise
            stamps.append(time.perf_counter())
            prof.step()

        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=warmup, active=steps,
                                       repeat=1)) as prof:
            opt.run(BATCH, train_step, crt, log_fns=[LogFn(tick)],
                    verbose=False)
            torch.cuda.synchronize()
        wall_ms = 1e3 * (stamps[-1] - stamps[warmup - 1]) / steps
    # device rows only (host ops carry the time of what they launch); the
    # Adam and profiler-step ranges overlap the kernels inside them
    rows = [(e.key, e.self_device_time_total / 1e3 / steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and 'Optimizer.step' not in e.key
            and 'ProfilerStep' not in e.key]
    busy_ms = sum(ms for _, ms in rows)
    if busy_ms <= 0.0:
        raise RuntimeError('torch.profiler recorded no device time')
    # a trace that lost events would understate its rows
    recorded = {name: sum(e.count for e in prof.key_averages()
                          if name in e.key)
                for name in ('fused_render_fwd_kernel',
                             'fused_render_bwd_kernel')}
    log(f'profile ({label}): {steps} steps, device busy {busy_ms:.3f} ms per '
        f'step = {busy_ms / wall_ms:.3f} of the profiled {wall_ms:.3f} ms '
        f'step, {busy_ms / step_ms:.3f} of the unprofiled {step_ms:.3f} ms '
        f'step (idle {1 - busy_ms / step_ms:.3f}); kernel launches in the '
        f'trace: {recorded}')
    for key, ms in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f'  {100 * ms / busy_ms:5.1f}% {ms:.3f} ms/step  {key[:90]}')
    for group, words in PROFILE_GROUPS:
        ms = sum(m for key, m in rows if any(w in key for w in words))
        log(f'  {group}: {ms:.3f} ms/step = {100 * ms / busy_ms:.1f}% of '
            f'the device time')
    return busy_ms


@contextlib.contextmanager
def patched(obj, name, value):
    """A context in which obj.name is value; the old value comes back on
    exit."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def alma_recorder():
    """Records what alma.get_raytracing_args traces and how long its parts
    take: the tables it hands to the host physics (alma._model_physics)
    and the seconds of the traces (image_plane_geos, trace_geodesics) and
    of the physics. Yields the record."""
    from bhnerf_tpu_torch import alma
    rec = {'geos': [], 'trace_s': 0.0, 'physics_s': 0.0}
    keys = {'image_plane_geos': 'trace_s', 'trace_geodesics': 'trace_s',
            '_model_physics': 'physics_s'}
    originals = {name: getattr(alma, name) for name in keys}

    def timed(name):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = originals[name](*args, **kwargs)
            rec[keys[name]] += time.perf_counter() - t0
            if name == '_model_physics':
                rec['geos'].append(args[0])
            return out
        return call

    for name in keys:
        setattr(alma, name, timed(name))
    try:
        yield rec
    finally:
        for name, fn in originals.items():
            setattr(alma, name, fn)


def alma_host_precompute(device):
    """The ALMA configuration through the port's entry points: a seeded
    sub-pixel ensemble of polarized ray constants, compacted in both
    layouts. Returns (predictor, crts, t_frames, the record of the host
    traces: alma_recorder's)."""
    from bhnerf_tpu_torch import alma, constants
    from bhnerf_tpu_torch.models.fields import NeRFPredictor
    from bhnerf_tpu_torch.train.step import compact_ensemble_args

    t0 = time.perf_counter()
    with alma_recorder() as host:
        rts = alma.get_raytracing_args(
            np.deg2rad(60.0), ALMA_MODEL['spin'], ALMA_MODEL,
            stokes=('I', 'Q', 'U'), rot_angle=np.deg2rad(32.2 + 20.0),
            num_subpixel_rays=ALMA_RAYS, rng=np.random.default_rng(0),
            device=device)
    t_host = time.perf_counter() - t0
    host['total_s'] = t_host
    rmax = ALMA_MODEL['fov_M'] / 2
    predictor = NeRFPredictor(
        scale=rmax, rmin=float(constants.isco_pro(ALMA_MODEL['spin'])),
        rmax=rmax, z_width=ALMA_MODEL['z_width'], net_depth=4,
        net_width=128, posenc_deg=3, learn_injection=True)
    for rt in rts:
        if rt.num_stokes != 3 or not bool(rt.J.isfinite().all()):
            raise RuntimeError('bad Stokes factors')
    crts = {layout: compact_ensemble_args(rts, predictor, layout=layout)
            for layout in ('gather', 'native')}
    n_dense = NUM_RAYS * NUM_RAYS * NGEO
    n_in = [int((c.t_geos_rel > -1e29).sum()) for c in crts['gather']]
    n_gather = crts['gather'][0].coords.shape[1]
    n_native = crts['native'][0].coords.shape[1]
    log(f'ALMA host precompute: {ALMA_RAYS} ray tables {NUM_RAYS}x'
        f'{NUM_RAYS}x{NGEO} (n_fine {N_FINE}, f64) with Stokes factors in '
        f'{t_host:.1f} s ({t_host / ALMA_RAYS:.1f} s a table); in domain '
        f'{n_in} of {n_dense} samples '
        f'({100 * np.mean(n_in) / n_dense:.1f}%); padded N: gather '
        f'{n_gather}, native {n_native} '
        f'({100 * (1 - max(n_in) / n_native):.1f}-'
        f'{100 * (1 - min(n_in) / n_native):.1f}% filler)')
    for layout, crt_list in crts.items():
        if len({tuple(c.coords.shape) for c in crt_list}) != 1:
            raise RuntimeError(f'{layout} ensemble is not uniformly shaped')
    # the observation: NT frames over the fit's 103-minute training span
    t_frames = (ALMA_MODEL['t_start_obs']
                + np.linspace(0.0, 103.0 / 60.0, NT)).astype(np.float32)
    return predictor, crts, t_frames, host


def alma_kernel_checks(predictor, crts, t_frames, device):
    """Both kernels against their plain versions at the 'native' sample
    count of the ALMA configuration (f32; forward with the stash,
    backward with the frame-time cotangent), with its filler columns
    checked; kernel times at the 'gather' count beside them."""
    import torch
    from bhnerf_tpu_torch.ops import fused

    out = {}
    for layout in ('native', 'gather'):
        crt = crts[layout][0]
        n = crt.coords.shape[1]
        common = kernel_inputs(predictor, crt, t_frames,
                               np.random.default_rng(2), device)
        _, _, omega, tg, _, weights, biases, cfg, _, deg = common
        em_k, f_k = fused.render_fwd(*common, 'float32', stash=True)
        em_p, f_p = fused.render_fwd_plain(*common, 'float32', stash=True)
        torch.cuda.synchronize()
        fwd_err = float((em_k - em_p).abs().max())
        f_err = float((f_k - f_p).abs().max())
        if not torch.allclose(em_k, em_p, atol=2e-6, rtol=1e-4) \
                or f_err > 1e-5 or float(em_p.max()) < 0.05:
            raise RuntimeError(f'ALMA {layout}: forward kernel disagrees '
                               f'with its plain version ({fwd_err:.3e}, '
                               f'features {f_err:.3e})')
        filler = tg[0] < -1e29
        if not bool((em_k[:, filler] == 0).all()) \
                or not bool((em_p[:, filler] == 0).all()):
            raise RuntimeError(f'ALMA {layout}: emission on padding columns '
                               f'is not exactly zero')
        rng = np.random.default_rng(3)
        target = torch.as_tensor(rng.random(em_p.shape), dtype=torch.float32,
                                 device=device)
        g_em = (2.0 * (em_p - target)).contiguous()
        bwd_args = (em_p, f_p, omega, weights, biases, cfg, deg, 'float32',
                    True)
        gk = fused.render_bwd(g_em, *bwd_args)
        gp = fused.render_bwd_plain(g_em, *bwd_args)
        # the backward must take nothing from padding columns, whatever
        # cotangent arrives there
        g_noise = g_em.clone()
        g_noise[:, filler] = 1e3 * torch.randn(
            (g_em.shape[0], int(filler.sum())), device=device,
            generator=torch.Generator(device).manual_seed(0))
        gn = fused.render_bwd(g_noise, *bwd_args)
        torch.cuda.synchronize()
        bwd_err, norm_err = grad_errors(gp, gk)
        dt_rel = float(((gk[2] - gp[2]).abs() / (gp[2].abs() + 1e-12)).max())
        if norm_err > 5e-5 or dt_rel > 2e-3:
            raise RuntimeError(f'ALMA {layout}: backward kernel disagrees: '
                               f'normalised {norm_err:.3e}, d_t {dt_rel:.3e}')
        if not all(torch.equal(a, b) for a, b in
                   zip(gk[0] + gk[1] + [gk[2]], gn[0] + gn[1] + [gn[2]])):
            raise RuntimeError(f'ALMA {layout}: padding columns leak into '
                               f'the gradients')
        n_params = sum(w.numel() + b.numel() for w, b in zip(weights, biases))
        feat = f_p.shape[0]
        ms = dict(
            fwd=cuda_ms(lambda: fused.render_fwd(*common, 'float32')),
            fwd_stash=cuda_ms(lambda: fused.render_fwd(*common, 'float32',
                                                       stash=True)),
            fwd_plain=cuda_ms(lambda: fused.render_fwd_plain(
                *common, 'float32', stash=True)),
            bwd=cuda_ms(lambda: fused.render_bwd(g_em, *bwd_args)),
            bwd_plain=cuda_ms(lambda: fused.render_bwd_plain(g_em,
                                                             *bwd_args)))
        fwd_b = bound('fwd', cfg, feat, BATCH, n, n_params, 'float32')
        bwd_b = bound('bwd', cfg, feat, BATCH, n, n_params, 'float32', True)
        log(f'ALMA {layout} N = {n} ({int(filler.sum())} padding columns, '
            f'exact zeros, no leak): fwd max|em_kernel - em_plain| = '
            f'{fwd_err:.3e} (atol 2e-6, rtol 1e-4), features {f_err:.3e}; '
            f'kernel {ms["fwd"]:.3f} ms (with stash {ms["fwd_stash"]:.3f}), '
            f'plain {ms["fwd_plain"]:.3f} ms, bound {fwd_b[0]:.3f} ms '
            f'({fwd_b[1]}), kernel at {100 * fwd_b[0] / ms["fwd"]:.1f}% of '
            f'it; bwd want_dt: max|dW_kernel - dW_plain| = {bwd_err:.3e}, '
            f'normalised {norm_err:.3e} (atol 5e-5), d_t rel err '
            f'{dt_rel:.3e} (rtol 2e-3); kernel {ms["bwd"]:.3f} ms, plain '
            f'{ms["bwd_plain"]:.3f} ms, bound {bwd_b[0]:.3f} ms '
            f'({bwd_b[1]}), kernel at {100 * bwd_b[0] / ms["bwd"]:.1f}% of '
            f'it')
        out[layout] = dict(n=n, fwd_err=fwd_err, bwd_err=bwd_err, ms=ms,
                           fwd_bound=fwd_b, bwd_bound=bwd_b)
    return out


def alma_target(predictor, crts, t_frames, device):
    """A seeded observation: the polarized movie and lightcurve of a
    random field (seeded weights, head bias lifted), rendered through the
    port in test mode over the whole ensemble and scaled to a mean Stokes
    I of 0.3, the intensity prior of the fit's configuration."""
    import torch
    from bhnerf_tpu_torch import units
    from bhnerf_tpu_torch.train.optimizer import TrainStep, total_movie_loss
    from bhnerf_tpu_torch.train.state import TrainState, make_optimizer

    truth = predictor.init_params(
        generator=torch.Generator().manual_seed(7), device=device)
    with torch.no_grad():
        truth.mlp.layers[-1].bias += 6.0
    render = TrainStep.image(units.Quantity(t_frames, 'hr'),
                             np.zeros((NT, 3), np.float32), predictor,
                             dtype='lc', fused=True, device=device)
    state = TrainState.create(truth, make_optimizer(1))
    _, movie = total_movie_loss(BATCH, state, render, crts['gather'],
                                return_frames=True)
    if movie.shape != (NT, 3, NUM_RAYS, NUM_RAYS) \
            or not np.isfinite(movie).all():
        raise RuntimeError(f'bad target movie {movie.shape}')
    movie = movie * (0.3 / movie[:, 0].sum(axis=(-1, -2)).mean())
    return movie.astype(np.float32)


def alma_train(label, train_step, crts, predictor, device, steps):
    """`steps` gradient steps of `train_step` over the ensemble `crts`
    with the injection offset at its own learning rate; checks launches,
    losses, variants and the test step over the ensemble. Returns
    (optimizer, step ms, launches)."""
    import torch
    from bhnerf_tpu_torch.ops import fused
    from bhnerf_tpu_torch.train.optimizer import LogFn, Optimizer

    opt = Optimizer({'num_iters': steps, 'lr_init': 1e-3, 'lr_final': 1e-4,
                     'lr_inject': 1e-3, 'seed': 0}, predictor, crts,
                    device=device)
    eval_frames = np.arange(BATCH)
    before = float(train_step(opt.state, crts, eval_frames,
                              update_state=False)[0])
    losses, stamps, drawn = [], [], []

    def record(o):
        losses.append(float(o.loss))    # synchronises: one step per stamp
        stamps.append(time.perf_counter())
        drawn.append(o.variant)

    fused.render_fwd.launches = 0
    fused.render_bwd.launches = 0
    opt.run(BATCH, train_step, crts, log_fns=[LogFn(record)], verbose=False)
    torch.cuda.synchronize()
    launches = (fused.render_fwd.launches, fused.render_bwd.launches)
    fused.render_fwd.launches = 0
    fused.render_bwd.launches = 0
    after, _, images = train_step(opt.state, crts, eval_frames,
                                  update_state=False)
    after = float(after)
    test_launches = (fused.render_fwd.launches, fused.render_bwd.launches)
    steps_per_s = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    log(f'{label}: {steps} steps at batch {BATCH} over {len(crts)} variants '
        f'(drawn {sorted(set(drawn))}), step losses {losses[0]:.6g} -> '
        f'{losses[-1]:.6g}, test loss over the ensemble {before:.6g} -> '
        f'{after:.6g}; launches fwd {launches[0]}, bwd {launches[1]}; test '
        f'step launches fwd {test_launches[0]}, bwd {test_launches[1]}; '
        f'{steps_per_s:.2f} steps/s over steps 2..{steps}; t_injection '
        f'offset {float(opt.state.params.t_injection.detach()):.4g}')
    if launches != (steps, steps):
        raise RuntimeError(f'{label}: expected one forward and one backward '
                           f'launch per step, got {launches}')
    if test_launches != (len(crts), 0):
        raise RuntimeError(f'{label}: a test step over {len(crts)} variants '
                           f'launched {test_launches}')
    if not np.all(np.isfinite(losses)) or not after < before:
        raise RuntimeError(f'{label}: loss did not fall: {before} -> '
                           f'{after}, steps {losses}')
    if set(drawn) != set(range(len(crts))):
        raise RuntimeError(f'{label}: variants drawn {sorted(set(drawn))}')
    if tuple(images.shape) != (BATCH, 3, NUM_RAYS, NUM_RAYS) \
            or not bool(torch.isfinite(images).all()):
        raise RuntimeError(f'{label}: bad images {tuple(images.shape)}')
    if float(opt.state.params.t_injection.detach()) == 0.0:
        raise RuntimeError(f'{label}: the injection offset did not move')
    return opt, 1e3 / steps_per_s, launches


def alma_chunked(train_step, crts, predictor, device):
    """ALMA_SCAN_STEPS steps of the 'lc' fit over the ensemble `crts` in
    chunks of ALMA_SCAN_CHUNK against the per-step loop from the same seed
    (the same batches and variants): the loss series must agree to float32
    round-off. Returns the chunked run's launches and its summary."""
    import torch
    from bhnerf_tpu_torch.ops import fused
    from bhnerf_tpu_torch.train.optimizer import LogFn, Optimizer

    runs = {}
    for scan_chunk in (0, ALMA_SCAN_CHUNK):
        opt = Optimizer({'num_iters': ALMA_SCAN_STEPS, 'lr_init': 1e-3,
                         'lr_final': 1e-4, 'lr_inject': 1e-3, 'seed': 0},
                        predictor, crts, device=device)
        losses, variants = [], []

        def record(o):
            # a device tensor in the per-step loop (no synchronise), a
            # host one replayed from the chunk in the chunked loop
            losses.append(o.loss)
            variants.append(o.variant)

        fused.render_fwd.launches = 0
        fused.render_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.run(BATCH, train_step, crts, log_fns=[LogFn(record)],
                verbose=False, scan_chunk=scan_chunk)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        runs[scan_chunk] = dict(
            losses=np.array([float(l) for l in losses]), variants=variants,
            launches=(fused.render_fwd.launches, fused.render_bwd.launches),
            steps_per_s=ALMA_SCAN_STEPS / wall_s)
    per_step, chunked = runs[0], runs[ALMA_SCAN_CHUNK]
    rel = float(np.max(np.abs(chunked['losses'] - per_step['losses'])
                       / np.abs(per_step['losses'])))
    log(f"ALMA 'lc' fit, gather layout, {ALMA_SCAN_STEPS} steps in chunks of "
        f'{ALMA_SCAN_CHUNK} against the per-step loop from the same seed: '
        f'the same variants {chunked["variants"] == per_step["variants"]}, '
        f'losses {per_step["losses"][0]:.6g} -> {per_step["losses"][-1]:.6g}'
        f', largest relative difference {rel:.3e} (rtol 1e-5; bitwise equal '
        f'{bool(np.array_equal(chunked["losses"], per_step["losses"]))}); '
        f'launches fwd {chunked["launches"][0]}, bwd '
        f'{chunked["launches"][1]}; {chunked["steps_per_s"]:.2f} against '
        f'{per_step["steps_per_s"]:.2f} steps/s')
    if chunked['launches'] != (ALMA_SCAN_STEPS, ALMA_SCAN_STEPS):
        raise RuntimeError(f'the chunked ALMA run launched '
                           f'{chunked["launches"]}')
    if chunked['variants'] != per_step['variants'] or rel > 1e-5 \
            or len(chunked['losses']) != ALMA_SCAN_STEPS \
            or not np.isfinite(chunked['losses']).all():
        raise RuntimeError('the chunked ALMA run differs from the per-step '
                           'run')
    return chunked['launches'], {
        'steps': ALMA_SCAN_STEPS, 'scan_chunk': ALMA_SCAN_CHUNK,
        'max_rel_loss_diff': rel, 'steps_per_s': chunked['steps_per_s'],
        'per_step_steps_per_s': per_step['steps_per_s']}


def alma_native_reduce_check(predictor, crt, t_frames, movie, device):
    """The polarized 'full' image loss through the 'native' reduce,
    forward and backward on the card, against the plain segment sum over
    the same slots."""
    import torch
    from bhnerf_tpu_torch.train import step

    segment = dataclasses.replace(crt, red_group_ids=None)
    idx = np.arange(BATCH)
    target = torch.as_tensor(movie[idx], device=device)
    sigma = torch.as_tensor(np.asarray(ALMA_SIGMA, np.float32)[:, None, None]
                            / NUM_RAYS, device=device)
    t_M = crt.frame_times_M(torch.as_tensor(t_frames[idx], device=device))
    results = []
    for args in (crt, segment):
        params = predictor.init_params(
            generator=torch.Generator().manual_seed(0), device=device)
        with torch.no_grad():
            params.mlp.layers[-1].bias += 4.0
        loss, [images] = step.loss_fn_image(
            params, predictor, target, sigma, 0.0, t_M, args, 1.0, 'full',
            fused=True)
        loss.backward()
        results.append((images.detach(), float(loss.detach()),
                        [p.grad for p in params.parameters()]))
    (img_n, loss_n, g_n), (img_s, loss_s, g_s) = results
    scale = float(img_s.abs().max())
    img_err = float((img_n - img_s).abs().max()) / scale
    g_err = max(float((a - b).abs().max() / (b.abs().max() + 1e-12))
                for a, b in zip(g_n, g_s))
    log(f"ALMA 'full' image loss, native reduce against segment sum: images "
        f'{tuple(img_n.shape)} differ by {img_err:.3e} of the max (atol '
        f'2e-5), loss {loss_n:.6g} against {loss_s:.6g} (rtol 1e-4), '
        f'gradients differ by {g_err:.3e} normalised (atol 1e-4)')
    if img_err > 2e-5 or abs(loss_n - loss_s) > 1e-4 * abs(loss_s) \
            or g_err > 1e-4 or scale <= 0.0:
        raise RuntimeError('native reduce disagrees with the segment sum')


def alma_phase(kernels, device):
    """The ALMA polarized-lightcurve fit at full width through the port's
    entry points; fills the ALMA keys of the JSON kernel entries and
    returns the summary of the chunked 'lc' run and the host precompute
    (alma_recorder's record, the predictor and the frame times)."""
    import torch
    from bhnerf_tpu_torch import units
    from bhnerf_tpu_torch.train import step
    from bhnerf_tpu_torch.train.optimizer import TrainStep

    predictor, crts, t_frames, host = alma_host_precompute(device)
    checks = alma_kernel_checks(predictor, crts, t_frames, device)
    movie = alma_target(predictor, crts, t_frames, device)
    lightcurve = movie.sum(axis=(-1, -2))
    log(f'ALMA target: lightcurves {lightcurve.shape}, mean I '
        f'{lightcurve[:, 0].mean():.3f}, mean |Q + iU| '
        f'{np.hypot(lightcurve[:, 1], lightcurve[:, 2]).mean():.3f}')
    t_q = units.Quantity(t_frames, 'hr')
    lc_step = TrainStep.image(t_q, lightcurve, predictor,
                              sigma=np.asarray(ALMA_SIGMA), dtype='lc',
                              fused=True, device=device)
    runs, launches = {}, [0, 0]
    for layout in ('gather', 'native'):
        runs[layout] = alma_train(f"ALMA 'lc' fit, {layout} layout", lc_step,
                                  crts[layout], predictor, device, STEPS)
        launches = [a + b for a, b in zip(launches, runs[layout][2])]

    chunked_launches, chunked = alma_chunked(lc_step, crts['gather'],
                                             predictor, device)
    alma_native_reduce_check(predictor, crts['native'][0], t_frames, movie,
                             device)
    full_step = TrainStep.image(
        t_q, movie, predictor, dtype='full', fused=True, device=device,
        sigma=np.asarray(ALMA_SIGMA)[:, None, None] / NUM_RAYS)
    for layout in ('gather', 'native'):
        alma_train(f"ALMA 'full' image fit, {layout} layout", full_step,
                   crts[layout], predictor, device, STEPS)

    # what the 'lc' step pays for its aux images, and the lightcurve product
    for layout in ('gather', 'native'):
        crt = crts[layout][0]
        em = torch.rand((BATCH, crt.coords.shape[1]), device=device)
        red_ms = cuda_ms(lambda: step._reduce_to_images(em, crt))
        mm_ms = cuda_ms(lambda: em @ crt.weights.T)
        log(f'ALMA {layout}: per-pixel reduce of the aux images '
            f'{red_ms:.3f} ms a step, em @ W^T {mm_ms:.3f} ms')
    for layout in ('gather', 'native'):
        opt, step_ms, _ = runs[layout]
        profile_path(f'ALMA lc, {layout}', opt, lc_step, crts[layout],
                     step_ms)

    steps = 2 * STEPS
    for entry, kind, count in zip(kernels, ('fwd', 'bwd'), launches):
        native, gather = checks['native'], checks['gather']
        entry.update({
            'alma_launches': count, 'alma_launches_per_step': count / steps,
            'alma_n': native['n'], 'alma_max_abs_err': native[kind + '_err'],
            'alma_ms': native['ms'][kind],
            'alma_plain_ms': native['ms'][kind + '_plain'],
            'alma_bound_ms': native[kind + '_bound'][0],
            'alma_bound_by': native[kind + '_bound'][1],
            'alma_gather_n': gather['n'],
            'alma_gather_ms': gather['ms'][kind],
            'alma_gather_bound_ms': gather[kind + '_bound'][0]})
        if kind == 'fwd':
            entry['alma_stash_ms'] = native['ms']['fwd_stash']
    for entry, count in zip(kernels, chunked_launches):
        entry.setdefault('scan', {})['alma_lc_chunked'] = count
    return chunked, dict(host, predictor=predictor, t_frames=t_frames)


def recovery_hotspot():
    """The hotspot of bench_recovery.py:99-103: 1.1 r_isco, std 0.7, on a
    RECOVERY_RES^3 grid over the field of view."""
    from bhnerf_tpu_torch import constants, emission
    r_isco = float(constants.isco_pro(SPIN))
    return emission.generate_hotspot(
        resolution=(RECOVERY_RES,) * 3, rot_axis=[0, 0, 1], rot_angle=0.0,
        orbit_radius=1.1 * r_isco, std=0.7, r_isco=r_isco, fov=FOV)


def recovery_target(geos, device):
    """The ground truth of bench_recovery.py:99-120: a hotspot at 1.1
    r_isco with std 0.7 on a RECOVERY_RES^3 grid over the field of view,
    and its movie of NT frames over an hour rendered on the card by
    emission.image_plane_dynamics, and the device memory a render chunk
    takes per sample and frame. Returns (hotspot, t_frames, t_injection,
    movie)."""
    import torch
    from bhnerf_tpu_torch import constants, emission, units, utils

    r_isco = float(constants.isco_pro(SPIN))
    hotspot = recovery_hotspot()
    t_frames = units.Quantity(np.linspace(0.0, 1.0, NT), 'hr')
    t_injection = -float(geos.r_o + FOV / 4)
    render = lambda frames, **kw: emission.image_plane_dynamics(
        hotspot, geos, geos.keplerian_omega(), frames, t_injection,
        t_start_obs=t_frames[0], device=device, **kw)
    t0 = time.perf_counter()
    movie = render(t_frames)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0

    # the peak device memory of one chunk of 4 and of 16 frames: its
    # growth per frame is what the chunk's temporaries take
    peaks = {}
    for chunk in (4, 16):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        part = render(t_frames[:chunk], frame_chunk=chunk)
        torch.cuda.synchronize()
        peaks[chunk] = torch.cuda.max_memory_allocated(device) - base
        if not torch.allclose(part, movie[:chunk], rtol=1e-5,
                              atol=1e-6 * float(movie.abs().max())):
            raise RuntimeError(f'a render chunk of {chunk} frames differs '
                               f'from the whole movie')
        del part
    n = NUM_RAYS * NUM_RAYS * NGEO
    bytes_per = (peaks[16] - peaks[4]) / (12 * n)
    movie = movie.cpu().numpy()
    lc = movie.sum(axis=(-1, -2))
    zero_psnr = utils.psnr(hotspot.data, np.zeros(hotspot.data.shape))
    log(f'recovery target: hotspot {RECOVERY_RES}^3 at r = {1.1 * r_isco:.3f}'
        f' (1.1 r_isco), integral {float(hotspot.integrate()):.6f}; movie '
        f'{movie.shape} rendered on the card in {t_render:.2f} s, lightcurve '
        f'{lc.min():.4g}..{lc.max():.4g}; a field of zeros scores '
        f'{zero_psnr:.2f} dB')
    log(f'render memory: peak {peaks[4]} B for a chunk of 4 frames, '
        f'{peaks[16]} B for 16, at {n} samples: {bytes_per:.1f} B per '
        f'sample and frame (image_plane_dynamics sizes its chunks for '
        f'{emission._BYTES_PER_SAMPLE_FRAME})')
    if movie.shape != (NT, NUM_RAYS, NUM_RAYS) or not np.isfinite(movie).all() \
            or not lc.min() > 0:
        raise RuntimeError(f'bad ground-truth movie {movie.shape}')
    if bytes_per > emission._BYTES_PER_SAMPLE_FRAME:
        raise RuntimeError('a render chunk takes more memory than '
                           'image_plane_dynamics sizes its chunks for')
    return hotspot, t_frames, t_injection, movie


def recovery_kernel_checks(predictor, crt, t_frames, device,
                           label='recovery', dtypes=('float32', 'bfloat16'),
                           batch=BATCH, want_dt=False):
    """Both kernels against their plain versions at the sample count of
    `crt` and a batch of `batch` frames drawn from `t_frames`, in each
    compute dtype of `dtypes` (those the fits run), with their times and
    bounds; with `want_dt` the backward also gives the frame-time
    cotangent (a learned injection time), held to rtol 2e-3. float32:
    emission atol 2e-6 / rtol 1e-4,
    F 1e-5, gradients 5e-5 normalised. bfloat16, against the plain
    version in bfloat16: emission atol 2e-3 / rtol 2e-2, F one bf16 step
    (2^-7), gradients 1e-2 normalised (the card tests' tolerances); and
    against the float32 plain version as on the main path: loss within
    2% and every gradient matrix at a cosine above 0.99."""
    import torch
    from bhnerf_tpu_torch.ops import fused

    n = crt.coords.shape[1]
    common = kernel_inputs(predictor, crt, t_frames, np.random.default_rng(4),
                           device, batch)
    _, _, omega, _, _, weights, biases, cfg, _, deg = common
    n_params = sum(w.numel() + b.numel() for w, b in zip(weights, biases))
    target = torch.as_tensor(np.random.default_rng(5).random((batch, n)),
                             dtype=torch.float32, device=device)
    em32, f32 = fused.render_fwd_plain(*common, 'float32', stash=True)
    g32 = (2.0 * (em32 - target)).contiguous()
    gp32 = fused.render_bwd_plain(g32, em32, f32, omega, weights, biases,
                                  cfg, deg, 'float32', want_dt)
    tols = {'float32': (dict(atol=2e-6, rtol=1e-4), 1e-5, 5e-5),
            'bfloat16': (dict(atol=2e-3, rtol=2e-2), 2.0 ** -7, 1e-2)}
    out = {}
    for dtype in dtypes:
        em_tol, f_tol, g_tol = tols[dtype]
        em_k, f_k = fused.render_fwd(*common, dtype, stash=True)
        em_p, f_p = fused.render_fwd_plain(*common, dtype, stash=True)
        g_em = (2.0 * (em_p - target)).contiguous()
        bwd_args = (em_p, f_p, omega, weights, biases, cfg, deg, dtype,
                    want_dt)
        gk = fused.render_bwd(g_em, *bwd_args)
        gp = fused.render_bwd_plain(g_em, *bwd_args)
        torch.cuda.synchronize()
        fwd_err = float((em_k - em_p).abs().max())
        f_err = float((f_k - f_p).abs().max())
        bwd_err, norm_err = grad_errors(gp, gk)
        dt_rel = float(((gk[2] - gp[2]).abs() / (gp[2].abs() + 1e-12))
                       .max()) if want_dt else 0.0
        line = (f'{label} N = {n}, {batch} frames, {dtype}: emission '
                f'{fwd_err:.3e} (atol '
                f'{em_tol["atol"]:g}, rtol {em_tol["rtol"]:g}), F '
                f'{f_err:.3e} (atol {f_tol:.3g}), gradients '
                f'{norm_err:.3e} normalised (atol {g_tol:.0e})'
                + (f', d_t rel err {dt_rel:.3e} (rtol 2e-3)' if want_dt
                   else ''))
        if not torch.allclose(em_k, em_p, **em_tol) or f_err > f_tol \
                or norm_err > g_tol or dt_rel > 2e-3:
            raise RuntimeError(f'kernels disagree with their plain versions: '
                               f'{line}')
        if dtype == 'bfloat16':
            loss_rel = abs(float(((em_k - target) ** 2).sum())
                           - float(((em32 - target) ** 2).sum())) \
                / float(((em32 - target) ** 2).sum())
            cos = min(float(torch.nn.functional.cosine_similarity(
                a.reshape(1, -1), b.reshape(1, -1))) for a, b in
                zip(gp32[0] + gp32[1], gk[0] + gk[1]))
            line += (f'; against float32 plain: loss rel diff {loss_rel:.3e}'
                     f' (< 0.02), min gradient cosine {cos:.6f} (> 0.99)')
            if loss_rel > 0.02 or cos < 0.99:
                raise RuntimeError(f'bf16 kernels stray from the f32 '
                                   f'reference: {line}')
        log(line)
        out[dtype] = {}
        for kind, err, run, plain in (
                ('fwd', fwd_err, lambda: fused.render_fwd(*common, dtype),
                 lambda: fused.render_fwd_plain(*common, dtype)),
                ('bwd', bwd_err, lambda: fused.render_bwd(g_em, *bwd_args),
                 lambda: fused.render_bwd_plain(g_em, *bwd_args))):
            ms, plain_ms = cuda_ms(run), cuda_ms(plain)
            b_ms, b_by, _ = bound(kind, cfg, f_p.shape[0], batch, n,
                                  n_params, dtype, want_dt)
            out[dtype][kind] = {'max_abs_err': err, 'ms': ms,
                                'plain_ms': plain_ms, 'bound_ms': b_ms,
                                'bound_by': b_by}
            log(f'{label} N = {n}, {batch} frames, {dtype} {kind}: kernel '
                f'{ms:.3f} ms, '
                f'plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), '
                f'kernel at {100 * b_ms / ms:.1f}% of it')
    return out


class strict_first_chunk:
    """Within this scope the first chunk that Optimizer.run runs (its
    Optimizer._chunk) runs under torch.cuda.set_sync_debug_mode('error'):
    any call inside it that synchronises with the card raises. `ran`
    counts the chunks that did."""

    def __enter__(self):
        import torch
        from bhnerf_tpu_torch.train.optimizer import Optimizer
        self.ran, self._chunk = 0, Optimizer._chunk
        chunk = self._chunk

        def strict(opt, *args):
            if self.ran:
                return chunk(opt, *args)
            self.ran += 1
            torch.cuda.set_sync_debug_mode('error')
            try:
                return chunk(opt, *args)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        Optimizer._chunk = strict
        return self

    def __exit__(self, *exc):
        from bhnerf_tpu_torch.train.optimizer import Optimizer
        Optimizer._chunk = self._chunk
        return False


def recovery_fit(compute_dtype, geos, hotspot, t_frames, t_injection, movie,
                 device, checkpoint_dir=''):
    """The recovery fit of bench_recovery.py:121-183 through the port's
    entry points: NeRFPredictor(scale 8, rmin 0, rmax 8, z_width 2)
    compacted in the 'gather' layout, TrainStep.image(dtype='full',
    fused=True), Adam at lr 1e-3 -> 1e-5 for RECOVERY_STEPS steps of batch
    BATCH in the per-step loop; then the volume PSNR on a RECOVERY_RES^3
    grid and the lightcurve error of the whole movie. Returns (result,
    optimizer, train_step, crt, launches)."""
    import torch
    from bhnerf_tpu_torch import utils
    from bhnerf_tpu_torch.models.fields import NeRFPredictor, sample_3d_grid
    from bhnerf_tpu_torch.ops import fused
    from bhnerf_tpu_torch.train.optimizer import (Optimizer, TrainStep,
                                                  total_movie_loss)
    from bhnerf_tpu_torch.train.step import (compact_raytracing_args,
                                             raytracing_args)

    predictor = NeRFPredictor(scale=FOV / 2, rmin=0.0, rmax=FOV / 2,
                              z_width=2.0, compute_dtype=compute_dtype)
    rt = raytracing_args(geos, geos.keplerian_omega(), t_injection,
                         t_frames[0], device=device)
    crt = compact_raytracing_args(rt, predictor, layout='gather')
    train_step = TrainStep.image(t_frames, movie, predictor, dtype='full',
                                 fused=True, device=device)
    opt = Optimizer({'num_iters': RECOVERY_STEPS, 'lr_init': 1e-3,
                     'lr_final': 1e-5}, predictor, crt,
                    save_period=RECOVERY_SAVE_PERIOD,
                    checkpoint_dir=checkpoint_dir, keep=1, device=device)
    fused.render_fwd.launches = 0
    fused.render_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.run(BATCH, train_step, crt, verbose=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = (fused.render_fwd.launches, fused.render_bwd.launches)

    vol = sample_3d_grid(predictor, opt.params, fov=FOV,
                         resolution=RECOVERY_RES)
    psnr_3d = utils.psnr(hotspot.data, vol)
    _, frames = total_movie_loss(8, opt.state, train_step, crt,
                                 return_frames=True)
    lc_rec, lc_true = frames.sum(axis=(-1, -2)), movie.sum(axis=(-1, -2))
    lc_err_pct = float(100.0 * np.mean(np.abs(lc_rec - lc_true))
                       / np.mean(lc_true))
    result = {'psnr_3d': psnr_3d, 'lc_err_pct': lc_err_pct, 'wall_s': wall_s,
              'steps_per_s': RECOVERY_STEPS / wall_s,
              'n': crt.coords.shape[1], 'steps': opt.state.step,
              'final_loss': float(opt.loss), 'scan_chunk': 0}
    n_in = int((crt.t_geos_rel > -1e29).sum())
    log(f'recovery fit, {compute_dtype}: {RECOVERY_STEPS} steps of batch '
        f'{BATCH} in the per-step loop at N = {result["n"]} ({n_in} samples '
        f'in the domain) in {wall_s:.2f} s '
        f'({result["steps_per_s"]:.2f} steps/s, checkpoints '
        f'{"every " + str(RECOVERY_SAVE_PERIOD) if checkpoint_dir else "off"}'
        f'); launches fwd {launches[0]}, bwd {launches[1]}; final loss '
        f'{result["final_loss"]:.6g}; psnr_3d {psnr_3d:.2f} dB (bar '
        f'{RECOVERY_MIN_PSNR}), lc_err_pct {lc_err_pct:.4f} (bar '
        f'{RECOVERY_MAX_LC_ERR_PCT}); the reference: 62.91 dB, 0.0883% '
        f'(bfloat16)')
    if launches != (RECOVERY_STEPS, RECOVERY_STEPS):
        raise RuntimeError(f'recovery fit ({compute_dtype}) launched '
                           f'{launches}, not one forward and one backward '
                           f'per step')
    if frames.shape != movie.shape or not np.isfinite(frames).all() \
            or vol.shape != (RECOVERY_RES,) * 3:
        raise RuntimeError(f'recovery fit ({compute_dtype}): bad outputs '
                           f'{frames.shape}, {vol.shape}')
    if not psnr_3d >= RECOVERY_MIN_PSNR \
            or not lc_err_pct <= RECOVERY_MAX_LC_ERR_PCT:
        raise RuntimeError(f'recovery fit ({compute_dtype}) missed the bar: '
                           f'{psnr_3d:.2f} dB, {lc_err_pct:.4f}%')
    return result, opt, train_step, crt, launches


def bench_recovery_run(label, steps, device, eht=False):
    """bhnerf_tpu_torch.bench_recovery.main (bench_recovery.py through the
    port's entry point) on the Tutorial-3 table that host_precompute
    traced, cached at N_FINE: its bfloat16 fit of `steps` steps in chunks
    of RECOVERY_SCAN_CHUNK (its default) after its warm-up chunks, the
    first chunk of the timed fit under set_sync_debug_mode('error'); with
    `eht` the npix-64 ngEHT recovery with the dense operator. One forward
    and one backward launch a step of the warm-up and of the fit, and one
    forward a batch of 8 frames of its total_movie_loss; psnr_3d and
    lc_err_pct against the mode's bar. Returns (result, optimizer,
    train_step, crt, launches of the whole call)."""
    import torch
    from bhnerf_tpu_torch import bench, bench_recovery
    from bhnerf_tpu_torch.ops import fused

    chunk = RECOVERY_SCAN_CHUNK
    warm = sum({min(chunk, steps), steps % chunk} - {0})
    want = (warm + steps + -(-NT // 8), warm + steps)
    min_psnr, max_lc = ((EHT_MIN_PSNR, EHT_MAX_LC_ERR_PCT) if eht else
                        (RECOVERY_MIN_PSNR, RECOVERY_MAX_LC_ERR_PCT))
    fused.render_fwd.launches = 0
    fused.render_bwd.launches = 0
    torch.cuda.synchronize()
    # its table at N_FINE (bench_tables cached it), not its 8192
    with patched(bench_recovery, 'cached_geos',
                 lambda *args: bench.cached_geos(*args[:-1], N_FINE)), \
            strict_first_chunk() as strict:
        run = bench_recovery.main(steps, eht=eht, device=device)
    launches = (fused.render_fwd.launches, fused.render_bwd.launches)
    line, opt = run.result, run.optimizer
    result = {'psnr_3d': line['psnr_3d'], 'lc_err_pct': line['lc_err_pct'],
              'wall_s': line['wall_s'], 'steps_per_s': steps / line['wall_s'],
              'n': run.crt.coords.shape[1], 'steps': opt.state.step,
              'final_loss': float(opt.loss), 'scan_chunk': chunk,
              'bench_recovery': line}
    log(f'{label}: bench_recovery.main({steps}{", eht=True" if eht else ""})'
        f' in chunks of {chunk}, the first under '
        f"set_sync_debug_mode('error'), at N = {result['n']} in "
        f'{line["wall_s"]:.2f} s ({result["steps_per_s"]:.2f} steps/s); '
        f'launches fwd {launches[0]}, bwd {launches[1]} (expected {want}: '
        f'{warm} warm-up steps, {steps} steps, the movie loss); final loss '
        f'{result["final_loss"]:.6g}; psnr_3d {line["psnr_3d"]:.2f} dB (bar '
        f'{min_psnr}), lc_err_pct {line["lc_err_pct"]:.4f} (bar {max_lc})')
    if strict.ran != 1:
        raise RuntimeError(f'{label}: {strict.ran} chunks ran under the sync '
                           f'check, not 1')
    if launches != want or opt.state.step != steps:
        raise RuntimeError(f'{label}: launches {launches}, not {want}; '
                           f'{opt.state.step} steps')
    if run.frames.shape != run.movie.shape or \
            not np.isfinite(run.frames).all() \
            or tuple(run.volume.shape) != (RECOVERY_RES,) * 3:
        raise RuntimeError(f'{label}: bad outputs {run.frames.shape}, '
                           f'{tuple(run.volume.shape)}')
    if not line['psnr_3d'] >= min_psnr or not line['lc_err_pct'] <= max_lc:
        raise RuntimeError(f'{label} missed the bar: {line}')
    return result, opt, run.train_step, run.crt, launches


def recovery_checkpoint_checks(opt, crt, checkpoint_dir, device):
    """The float32 fit's checkpoints: restore_params equals
    Optimizer.params bitwise; a fresh Optimizer on the directory reports
    the last step with bitwise the same Adam state; keep=1 left only the
    last checkpoint, beside the predictor's yaml."""
    import torch
    from bhnerf_tpu_torch.train.optimizer import Optimizer
    from bhnerf_tpu_torch.train.state import restore_params

    saved = restore_params(checkpoint_dir)
    live = opt.params.state_dict()
    if saved.keys() != live.keys() or not all(
            torch.equal(saved[k], v.cpu()) for k, v in live.items()):
        raise RuntimeError('restore_params differs from Optimizer.params')
    resumed = Optimizer({'num_iters': RECOVERY_STEPS, 'lr_init': 1e-3,
                         'lr_final': 1e-5}, opt.predictor, crt,
                        checkpoint_dir=checkpoint_dir, device=device)
    a, b = opt.state.opt.state_dict(), resumed.state.opt.state_dict()
    same_adam = a['state'].keys() == b['state'].keys() and all(
        torch.equal(a['state'][i][k].cpu(), b['state'][i][k].cpu())
        for i in a['state'] for k in ('step', 'exp_avg', 'exp_avg_sq'))
    left = sorted(p.name for p in os.scandir(checkpoint_dir))
    log(f'recovery checkpoints: restore_params equals Optimizer.params '
        f'bitwise; a fresh Optimizer resumes at step {resumed.state.step} '
        f'with {"bitwise the same" if same_adam else "a DIFFERENT"} Adam '
        f'state; the directory holds {left}')
    if resumed.state.step != RECOVERY_STEPS or not same_adam:
        raise RuntimeError('the resumed Optimizer differs from the saved one')
    if left != sorted([f'checkpoint_{RECOVERY_STEPS}',
                       'NeRF_Predictor_params.yml']):
        raise RuntimeError(f'keep=1 left {left}')


def recovery_phase(kernels, geos, device):
    """The Tutorial-3 recovery of bench_recovery.py on the card, in float32
    (with checkpoints) and bfloat16: ground truth, fit, psnr_3d and
    lc_err_pct against the bar. Fills the recovery keys of the JSON kernel
    entries and returns the recovery summary."""

    hotspot, t_frames, t_injection, movie = recovery_target(geos, device)
    fit = lambda compute_dtype, ckpt='': recovery_fit(
        compute_dtype, geos, hotspot, t_frames, t_injection, movie, device,
        ckpt)
    runs = {}
    with tempfile.TemporaryDirectory() as ckpt:
        runs['float32'] = fit('float32', ckpt)
        _, opt, _, crt, _ = runs['float32']
        recovery_checkpoint_checks(opt, crt, ckpt, device)
        opt.checkpoint_dir = ''
    runs['bfloat16'] = fit('bfloat16')
    runs['bfloat16_chunked'] = bench_recovery_run(
        'recovery fit, bfloat16, chunked', RECOVERY_STEPS, device)
    # the fit's loop synchronises only at its end: the device's busy
    # share against that loop's step time
    idle = {}
    for name, (result, opt, train_step, crt, _) in runs.items():
        step_ms = 1e3 / result['steps_per_s']
        busy_ms = profile_path(
            f'recovery {name}', opt, train_step, crt, step_ms,
            steps=50 if result['scan_chunk'] else 10,
            scan_chunk=result['scan_chunk'])
        idle[name] = result['device_idle_share'] = 1.0 - busy_ms / step_ms
    per_step, chunked = runs['bfloat16'][0], runs['bfloat16_chunked'][0]
    log(f'recovery bf16, chunked against per-step: '
        f'{chunked["steps_per_s"]:.2f} against {per_step["steps_per_s"]:.2f}'
        f' steps/s, device idle {idle["bfloat16_chunked"]:.3f} against '
        f'{idle["bfloat16"]:.3f} of a step; psnr_3d '
        f'{chunked["psnr_3d"]:.2f} against {per_step["psnr_3d"]:.2f} dB')
    # both fits compact the same samples
    checks = recovery_kernel_checks(opt.predictor, crt,
                                    np.asarray(t_frames.value, np.float32),
                                    device)
    for i, (entry, kind) in enumerate(zip(kernels, ('fwd', 'bwd'))):
        entry['recovery'] = {
            'n': crt.coords.shape[1],
            'launches': {k: run[4][i] for k, run in runs.items()},
            **{dtype: c[kind] for dtype, c in checks.items()}}
        entry.setdefault('scan', {})['recovery_bf16_chunked'] = \
            runs['bfloat16_chunked'][4][i]
    return {k: run[0] for k, run in runs.items()}


def fit_script_phase(kernels, device):
    """The fit script's sweep (bhnerf_tpu_torch.scripts.
    fit_alma_lp_apr11_sgra_flare.run_sweep) at the configuration's full
    width on a synthetic observation, with writers that keep the logs in
    memory: FIT_INCS x seed FIT_SEED, FIT_STEPS steps each in chunks of
    FIT_PERIOD with logs and checkpoints every FIT_PERIOD steps; both
    kernels against their plain versions (float32) on each inclination's
    compacted ray constants, at the training batch and at the 20-frame
    batch of the datafit renders; chi2_df over the inclinations (both
    cells at step FIT_STEPS) from host tables and, beside it, from tables
    of the device tracer (backend='device'); then --resume of the first run to
    FIT_RESUME_STEPS, which must continue from FIT_STEPS. Fills the
    fit_sweep block of the JSON kernel entries and returns the phase's
    summary."""
    import torch
    from bhnerf_tpu_torch import alma, config, units
    from bhnerf_tpu_torch.geodesics import integrator
    from bhnerf_tpu_torch.ops import fused
    from bhnerf_tpu_torch.scripts import fit_alma_lp_apr11_sgra_flare as fit
    from bhnerf_tpu_torch.train.logging import MemoryWriter

    t_phase = time.perf_counter()
    trace = {'ngeo': NGEO, 'n_fine': N_FINE}
    with tempfile.TemporaryDirectory() as root:
        cfg = config.RunConfig.from_yaml(fit.CONFIG_PATH)
        cfg.preprocess.data_path = fit.write_synthetic_observation(
            os.path.join(root, 'obs.csv'))
        opt_cfg = cfg.optimization
        opt_cfg.log_dir = os.path.join(root, 'runs')
        opt_cfg.checkpoint_dir = os.path.join(root, 'ckpt')
        opt_cfg.hparams.num_iters = FIT_STEPS
        opt_cfg.scan_chunk = opt_cfg.log_period = opt_cfg.save_period = \
            FIT_PERIOD
        _, train, val = fit.split_data(cfg, device)
        kw = dict(device=device, model_overrides=trace, verbose=False)

        def sweep(incs, **extra):
            fused.render_fwd.launches = 0
            fused.render_bwd.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            records = fit.run_sweep(cfg, incs, [FIT_SEED], MemoryWriter,
                                    **kw, **extra)
            torch.cuda.synchronize()
            return records, time.perf_counter() - t0, (
                fused.render_fwd.launches, fused.render_bwd.launches)

        records, sweep_s, launches = sweep(list(FIT_INCS))
        # each log renders the training and validation movies (one forward
        # launch per 20 frames); the training steps launch the rest
        logs = FIT_STEPS // FIT_PERIOD
        test_fwd = logs * (-(-len(train['t']) // 20) - (-len(val['t']) // 20))
        for r in records:
            w = r['writer']
            losses = [v for _, v in w.scalars['log_loss/train']]
            log(f'fit script: {r["run"]} steps {r["first_step"]}..'
                f'{r["last_step"]}, log10 training loss {losses[0]:.4f} -> '
                f'{losses[-1]:.4f}; datafit training '
                f'{w.scalars["datafit/training"]}, validation '
                f'{w.scalars["datafit/validation"]}; volumes at steps '
                f'{[s for s, _ in w.volumes["emission/estimate"]]}')
            if (r['first_step'], r['last_step']) != (1, FIT_STEPS) \
                    or len(losses) != FIT_STEPS \
                    or not np.isfinite(losses).all():
                raise RuntimeError(f'fit script: bad run {r["run"]}')
        expected = (len(FIT_INCS) * (FIT_STEPS + test_fwd),
                    len(FIT_INCS) * FIT_STEPS)
        log(f'fit script: {len(records)} runs of {FIT_STEPS} steps '
            f'({len(train["t"])} training and {len(val["t"])} validation '
            f'frames, ensemble of {cfg.model.num_subrays}) in {sweep_s:.1f} s'
            f' with the host traces; launches fwd {launches[0]}, bwd '
            f'{launches[1]} (expected {expected})')
        if len(records) != len(FIT_INCS) or launches != expected:
            raise RuntimeError(f'fit script: {len(records)} runs, launches '
                               f'{launches}')

        # the kernels at the sweep's shapes: each inclination's 'gather'
        # table of one variant (learn_injection off, so no frame-time
        # cotangent), the training batch and the datafit renders' batch
        checks = {}
        t_train = np.asarray(train['t'], np.float32)
        for r in records:
            opt = r['optimizer']
            for v, crt in enumerate(opt.raytracing_args):
                for batch in (BATCH, 20):
                    c = recovery_kernel_checks(
                        opt.predictor, crt, t_train, device,
                        label=f'fit sweep inc {r["inclination"]:g} variant '
                              f'{v}', dtypes=('float32',), batch=batch)
                    checks[f'inc_{r["inclination"]:g}_v{v}_b{batch}'] = \
                        dict(n=crt.coords.shape[1], float32=c['float32'])

        # chi2 of the cells as the sweep left them: both at FIT_STEPS
        t0 = time.perf_counter()
        df = alma.chi2_df(
            list(FIT_INCS), cfg.model.spin, [FIT_SEED],
            dict(cfg.model.asdict(), **trace),
            os.path.join(opt_cfg.checkpoint_dir, fit.RUN_NAME),
            units.Quantity(train['t'], 'hr'), train['data'],
            sigma=np.asarray(opt_cfg.sigma),
            rot_angle=np.deg2rad(cfg.preprocess.de_rot_angle + 20.0),
            num_subpixel_rays=cfg.model.num_subrays,
            checkpoint_name=f'checkpoint_{FIT_STEPS}', device=device)
        chi2_s = time.perf_counter() - t0
        chi2 = df.values
        log(f'fit script chi2_df at step {FIT_STEPS} ({chi2_s:.1f} s): '
            + ', '.join(f'inc {inc:g}: {c:.6g}'
                        for inc, c in zip(df.index, chi2[:, 0])))
        if chi2.shape != (len(FIT_INCS), 1) or not np.isfinite(chi2).all():
            raise RuntimeError(f'chi2_df: {df}')
        # the same chi^2 with the tables traced by the device tracer: one
        # launch a grid point (an inclination of the one seed), the whole
        # sub-pixel ensemble in it whatever num_subrays is
        integrator.trace_rays.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df_dev = alma.chi2_df(
            list(FIT_INCS), cfg.model.spin, [FIT_SEED],
            dict(cfg.model.asdict(), **trace),
            os.path.join(opt_cfg.checkpoint_dir, fit.RUN_NAME),
            units.Quantity(train['t'], 'hr'), train['data'],
            sigma=np.asarray(opt_cfg.sigma),
            rot_angle=np.deg2rad(cfg.preprocess.de_rot_angle + 20.0),
            num_subpixel_rays=cfg.model.num_subrays,
            checkpoint_name=f'checkpoint_{FIT_STEPS}', backend='device',
            device=device)
        torch.cuda.synchronize()
        chi2_dev_s = time.perf_counter() - t0
        chi2_dev_launches = integrator.trace_rays.launches
        chi2_dev = df_dev.values
        log(f"fit script chi2_df(backend='device') at step {FIT_STEPS} "
            f'({chi2_dev_s:.1f} s against {chi2_s:.1f} s on the host, '
            f'{chi2_dev_launches} tracer launches): '
            + ', '.join(f'inc {inc:g}: {c:.6g} (host {h:.6g}, '
                        f'{100 * (c - h) / h:+.3f}%)' for inc, c, h in
                        zip(df_dev.index, chi2_dev[:, 0], chi2[:, 0])))
        if chi2_dev.shape != chi2.shape \
                or not np.isfinite(chi2_dev).all() \
                or chi2_dev_launches != len(FIT_INCS):
            raise RuntimeError(f"chi2_df(backend='device'): {df_dev}, "
                               f'{chi2_dev_launches} launches')

        opt_cfg.hparams.num_iters = FIT_RESUME_STEPS
        resumed, resume_s, resume_launches = sweep(list(FIT_INCS[:1]),
                                                   resume=True)
        (r,) = resumed
        steps = [s for s, _ in r['writer'].scalars['log_loss/train']]
        log(f'fit script --resume: {r["run"]} continued at step '
            f'{r["first_step"]} to {r["last_step"]} in {resume_s:.1f} s; '
            f'launches fwd {resume_launches[0]}, bwd {resume_launches[1]}')
        if (r['first_step'], r['last_step']) != (FIT_STEPS + 1,
                                                 FIT_RESUME_STEPS) \
                or steps[0] != FIT_STEPS + 1 \
                or resume_launches[1] != FIT_RESUME_STEPS - FIT_STEPS:
            raise RuntimeError('fit script: the resume did not continue '
                               'from the saved step')
    phase_s = time.perf_counter() - t_phase
    log(f'fit script phase: {phase_s:.1f} s')
    for i, (entry, kind) in enumerate(zip(kernels, ('fwd', 'bwd'))):
        entry['fit_sweep'] = {
            'launches': launches[i], 'resume_launches': resume_launches[i],
            **{name: dict(n=c['n'], float32=c['float32'][kind])
               for name, c in checks.items()}}
    return {'runs': len(records), 'steps': FIT_STEPS, 'sweep_s': sweep_s,
            'resume_s': resume_s, 'chi2_s': chi2_s, 'phase_s': phase_s,
            'chi2': {str(k): float(v) for k, v in zip(df.index, chi2[:, 0])},
            'chi2_device_s': chi2_dev_s,
            'chi2_device_launches': chi2_dev_launches,
            'chi2_device': {str(k): float(v)
                            for k, v in zip(df_dev.index, chi2_dev[:, 0])}}


def eht_observation(geos, hotspot, npix, device):
    """bench_recovery.py:97-133 with --eht for the npix x npix table
    `geos`: the hotspot's movie of NT frames over 4.0-15.5 UT rendered on
    the card by emission.image_plane_dynamics, observed by the ngEHT array
    (empty_eht_obs, NT scans of EHT_TINT s) with thermal noise of seed 0
    at a pixel size of fov_rad / npix. Returns (t_frames, t_injection,
    movie, obs, fov_rad)."""
    import torch
    from bhnerf_tpu_torch import constants, emission, observation, units

    t_frames = units.Quantity(np.linspace(4.0, 15.5, NT).astype(np.float32),
                              'hr')
    t_injection = -float(geos.r_o + FOV / 4)
    t0 = time.perf_counter()
    movie = emission.image_plane_dynamics(
        hotspot, geos, geos.keplerian_omega(), t_frames, t_injection,
        device=device)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    movie = movie.cpu().numpy()
    array = observation.load_txt(os.path.join(REPO, 'eht_arrays',
                                              'ngEHT.txt'))
    fov_rad = float(FOV * constants.GM_c2(constants.sgra_mass).value
                    / constants.sgra_distance.to('m').value)
    t0 = time.perf_counter()
    obs = observation.observe_same(
        movie, np.asarray(t_frames.value), fov_rad / npix,
        observation.empty_eht_obs(array, nt=NT, tint=EHT_TINT),
        thermal_noise=True, seed=0)
    t_obs = time.perf_counter() - t0
    lc = movie.sum(axis=(-1, -2))
    log(f'EHT npix {npix}: movie {movie.shape} over {float(t_frames[0].value)}'
        f'-{float(t_frames[-1].value)} UT rendered on the card in '
        f'{t_render:.2f} s, lightcurve {lc.min():.4g}..{lc.max():.4g}; ngEHT '
        f'({array.nstations} stations) observed it in {t_obs:.1f} s: '
        f'{int(obs.mask.sum())} visibilities in {obs.nscan} scans, '
        f'{obs.mask.sum(1).min()}-{obs.mask.sum(1).max()} a scan')
    if movie.shape != (NT, npix, npix) or not np.isfinite(movie).all() \
            or not lc.min() > 0 or not np.isfinite(obs.vis[obs.mask]).all():
        raise RuntimeError(f'EHT npix {npix}: bad movie or observation')
    return t_frames, t_injection, movie, obs, fov_rad


def eht_step(t_frames, obs, fov_rad, npix, predictor, operator, device):
    """TrainStep.eht('vis', fused) with the `operator` form; prints what
    its measurements hold on the card."""
    import torch
    from bhnerf_tpu_torch.train.optimizer import TrainStep

    t0 = time.perf_counter()
    train_step = TrainStep.eht(t_frames, obs, fov_rad, npix, predictor,
                               dtype='vis', fused=True, operator=operator,
                               device=device)
    _, sigma, A, _ = train_step.args[0].device_args
    torch.cuda.synchronize()
    valid = torch.isfinite(sigma[:, 0]).sum(-1)
    a_bytes = A.numel() * A.element_size()
    log(f'EHT npix {npix}, {operator} operator: chisqdata, '
        f'to_real_measurements and upload in {time.perf_counter() - t0:.1f} '
        f's; nvis per frame {A.shape[-2]} ({int(valid.min())}-'
        f'{int(valid.max())} valid); A {tuple(A.shape)} {A.dtype} = '
        f'{a_bytes} B on the card ({a_bytes / NT / 1e6:.3f} MB a frame)')
    if A.dtype != torch.float32 or not bool(torch.isfinite(A).all()):
        raise RuntimeError('EHT operator is not finite float32')
    return train_step, {'nvis': A.shape[-2], 'a_bytes': a_bytes,
                        'a_shape': list(A.shape)}


def eht_fit(device):
    """(a) bench_recovery.py --eht at npix 64 through the port's entry
    point, bench_recovery.main(EHT_STEPS, eht=True) (bench_recovery_run):
    the recovery predictor (rmin 0) in bfloat16, compacted in the 'gather'
    layout, TrainStep.eht('vis', fused=True, operator='dense'), EHT_STEPS
    steps in chunks of EHT_SCAN_CHUNK; psnr_3d and lc_err_pct against the
    bar; what its measurements hold on the card, a profile, then both
    kernels against their plain versions in bfloat16 at the fit's N over
    the EHT window. Returns (result, launches)."""
    import torch

    result, opt, train_step, crt, launches = bench_recovery_run(
        f'EHT fit, npix {NUM_RAYS}, dense, bfloat16', EHT_STEPS, device,
        eht=True)
    _, sigma, A, _ = train_step.args[0].device_args
    valid = torch.isfinite(sigma[:, 0]).sum(-1)
    a_bytes = A.numel() * A.element_size()
    log(f'EHT npix {NUM_RAYS}, dense operator: nvis per frame {A.shape[-2]} '
        f'({int(valid.min())}-{int(valid.max())} valid); A {tuple(A.shape)} '
        f'{A.dtype} = {a_bytes} B on the card ({a_bytes / NT / 1e6:.3f} MB a '
        f'frame); the reference: 52.5 dB, 0.215% (bfloat16)')
    if A.dtype != torch.float32 or not bool(torch.isfinite(A).all()):
        raise RuntimeError('EHT operator is not finite float32')
    result.update({'nvis': A.shape[-2], 'a_bytes': a_bytes,
                   'a_shape': list(A.shape)})
    result['device_ms_per_step'] = profile_path(
        'EHT npix 64 dense bf16', opt, train_step, crt, 1e3 / result[
            'steps_per_s'], steps=50, scan_chunk=EHT_SCAN_CHUNK)
    t_frames = np.asarray(train_step.args[0].args[-1], np.float32)
    result['bfloat16'] = recovery_kernel_checks(
        opt.predictor, crt, t_frames, device,
        label=f'EHT npix {NUM_RAYS}', dtypes=('bfloat16',))['bfloat16']
    return result, launches


def eht_operators_agree(steps, crt, predictor, device):
    """The dense and the factored operator on one fixed frame batch and
    set of params (seeded, head bias lifted so that the images are
    macroscopic), through the kernels: the vis loss within rtol 1e-4, the
    visibilities of the same images within rtol 2e-4 and atol 2e-5 of the
    largest (tests/test_observation.py:809's tolerance, there on
    unit-scale images), and the normalised gradient difference."""
    import torch
    from bhnerf_tpu_torch.train import step

    idx = torch.as_tensor(np.random.default_rng(8).choice(NT, BATCH, False),
                          device=device)
    out = {}
    for operator, train_step in steps.items():
        params = predictor.init_params(
            generator=torch.Generator().manual_seed(0), device=device)
        with torch.no_grad():
            params.mlp.layers[-1].bias += 8.0
        target, sigma, A, t_hr = (x.index_select(0, idx) for x in
                                  train_step.args[0].device_args)
        loss, [images] = step.loss_fn_eht(
            params, predictor, target, sigma, A, crt.frame_times_M(t_hr), crt,
            1.0, 'vis', fused=True)
        loss.backward()
        with torch.no_grad():
            vis = step.apply_measurement_operator(images, A)
        out[operator] = (float(loss.detach()), vis,
                         [p.grad for p in params.parameters()])
    (l_d, v_d, g_d), (l_f, v_f, g_f) = out['dense'], out['factored']
    vmax = float(v_d.abs().max())
    diff = (v_f - v_d).abs()
    v_err = float(diff.max()) / vmax
    # <= 1 where every visibility is inside rtol 2e-4 / atol 2e-5 * vmax
    v_tol = float((diff / (2e-4 * v_d.abs() + 2e-5 * vmax)).max())
    g_err = max(float((a - b).abs().max() / (a.abs().max() + 1e-12))
                for a, b in zip(g_d, g_f))
    loss_rel = abs(l_f - l_d) / abs(l_d)
    log(f'EHT npix {EHT_NPIX_PRODUCTION}, dense against factored on one batch '
        f'{idx.tolist()}: vis loss {l_d:.10g} against {l_f:.10g} (rel '
        f'{loss_rel:.3e}, rtol 1e-4); visibilities differ by at most '
        f'{v_err:.3e} of the largest |V| ({vmax:.4g}), {v_tol:.3f} of the '
        f'tolerance rtol 2e-4 + atol 2e-5 of the largest; gradients differ '
        f'by {g_err:.3e} normalised')
    if not loss_rel <= 1e-4 or not v_tol <= 1.0 or not vmax > 0:
        raise RuntimeError('dense and factored operators disagree')
    return {'loss_rel': loss_rel, 'vis_err': v_err, 'vis_tol_share': v_tol,
            'grad_err': g_err}


def eht_operator_run(label, train_step, crt, predictor, device):
    """EHT_OPERATOR_STEPS steps of `train_step` in the per-step loop (the
    loop synchronises at its end only) and 10 profiled steps. Returns
    (steps/s, device ms per step, launches)."""
    import torch
    from bhnerf_tpu_torch.ops import fused
    from bhnerf_tpu_torch.train.optimizer import Optimizer

    opt = Optimizer({'num_iters': EHT_OPERATOR_STEPS, 'lr_init': 1e-3,
                     'lr_final': 1e-5}, predictor, crt, device=device)
    fused.render_fwd.launches = 0
    fused.render_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.run(BATCH, train_step, crt, verbose=False)
    torch.cuda.synchronize()
    steps_per_s = EHT_OPERATOR_STEPS / (time.perf_counter() - t0)
    launches = (fused.render_fwd.launches, fused.render_bwd.launches)
    log(f'{label}: {EHT_OPERATOR_STEPS} steps of batch {BATCH} at N = '
        f'{crt.coords.shape[1]}, {steps_per_s:.2f} steps/s; launches fwd '
        f'{launches[0]}, bwd {launches[1]}; final loss {float(opt.loss):.6g}')
    if launches != (EHT_OPERATOR_STEPS, EHT_OPERATOR_STEPS) \
            or not np.isfinite(float(opt.loss)):
        raise RuntimeError(f'{label}: launches {launches}, loss {opt.loss}')
    busy_ms = profile_path(label, opt, train_step, crt, 1e3 / steps_per_s)
    return steps_per_s, busy_ms, launches


def eht_production(hotspot, device):
    """(b) the production operator at npix EHT_NPIX_PRODUCTION: its table
    from the host tracer, both kernels against their plain versions at its
    N over the ngEHT window in float32 and bfloat16, dense against
    factored, and EHT_OPERATOR_STEPS steps of each in float32. Returns
    (summary, kernel checks)."""
    from bhnerf_tpu_torch.geodesics import image_plane_geos
    from bhnerf_tpu_torch.models.fields import NeRFPredictor
    from bhnerf_tpu_torch.train.step import (compact_raytracing_args,
                                             raytracing_args)

    npix = EHT_NPIX_PRODUCTION
    t0 = time.perf_counter()
    geos = image_plane_geos(spin=SPIN, inclination=np.deg2rad(60.0),
                            alpha_range=(-FOV / 2, FOV / 2),
                            beta_range=(-FOV / 2, FOV / 2), ngeo=NGEO,
                            num_alpha=npix, num_beta=npix, n_fine=N_FINE)
    t_geo = time.perf_counter() - t0
    for f in ('r', 'theta', 'phi', 't'):
        if not np.isfinite(getattr(geos, f)).all():
            raise RuntimeError(f'non-finite geodesic table {f}')
    t_frames, t_injection, _, obs, fov_rad = eht_observation(
        geos, hotspot, npix, device)
    predictor = NeRFPredictor(scale=FOV / 2, rmin=0.0, rmax=FOV / 2,
                              z_width=2.0)
    rt = raytracing_args(geos, geos.keplerian_omega(), t_injection,
                         t_frames[0], device=device)
    crt = compact_raytracing_args(rt, predictor, layout='gather')
    n_in = int((crt.t_geos_rel > -1e29).sum())
    log(f'EHT npix {npix}: geodesics {npix}x{npix}x{NGEO} (n_fine {N_FINE}, '
        f'f64) in {t_geo:.1f} s; compacted {n_in}/{npix * npix * NGEO} '
        f'samples, padded N = {crt.coords.shape[1]}')
    checks = recovery_kernel_checks(
        predictor, crt, np.asarray(t_frames.value, np.float32), device,
        label=f'EHT npix {npix}')
    steps, data = {}, {}
    for operator in ('dense', 'factored'):
        steps[operator], data[operator] = eht_step(
            t_frames, obs, fov_rad, npix, predictor, operator, device)
    agree = eht_operators_agree(steps, crt, predictor, device)
    runs = {op: eht_operator_run(f'EHT npix {npix} {op} f32', steps[op],
                                 crt, predictor, device)
            for op in ('dense', 'factored')}
    summary = {'n': crt.coords.shape[1], 'n_in_domain': n_in,
               'geodesics_s': t_geo, **agree,
               **{op: {**data[op], 'steps_per_s': r[0],
                       'device_ms_per_step': r[1]}
                  for op, r in runs.items()}}
    launches = {op: r[2] for op, r in runs.items()}
    return summary, checks, launches


def eht_phase(kernels, device):
    """The EHT visibility path on the card: (a) the npix-64 recovery fit,
    (b) the npix-128 production operator. Fills the EHT keys of the JSON
    kernel entries and returns the EHT summary."""
    t0 = time.perf_counter()
    fit, fit_launches = eht_fit(device)
    t_fit = time.perf_counter() - t0
    production, checks, launches = eht_production(recovery_hotspot(), device)
    log(f'EHT phase: {time.perf_counter() - t0:.1f} s, of which the npix-64 '
        f'fit {t_fit:.1f} s')
    for i, (entry, kind) in enumerate(zip(kernels, ('fwd', 'bwd'))):
        entry['eht'] = {
            'launches': fit_launches[i], 'n': fit['n'],
            'bfloat16': fit['bfloat16'][kind],
            'npix128': {'n': production['n'],
                        'launches': {op: l[i] for op, l in launches.items()},
                        **{dtype: c[kind] for dtype, c in checks.items()}}}
    return {'npix64_dense_bf16': fit, 'npix128_f32': production}


def trace_state(alpha, beta, spin, device, inc=np.deg2rad(60.0)):
    """initial_state of the float32 trace at inclination `inc` (60 deg)
    for the screen points (alpha, beta), on the card: (state0, lam,
    eta)."""
    import torch
    from bhnerf_tpu_torch.geodesics import integrator
    state0, lam, eta = integrator.initial_state(
        np.ravel(np.asarray(alpha, np.float32)),
        np.ravel(np.asarray(beta, np.float32)), spin, inc, 1000.0,
        torch.float32)
    return (integrator.RayState(*(x.to(device) for x in state0)),
            lam.to(device), eta.to(device))


def screen(npix, fov=FOV):
    """The regular npix x npix screen grid over the field of view."""
    axis = np.linspace(-fov / 2, fov / 2, npix)
    return np.meshgrid(axis, axis, indexing='ij')


def as_table(samples):
    """(r, theta, t, phi, pm_r, pm_th) of the tracer's samples, (rays,
    ngeo) each, as trace_geodesics forms them: 1/u and arccos(c) in
    float32, t - t_c folded in float64, phi and the signs as recorded."""
    s = {k: v.cpu().numpy().T for k, v in samples.items()}
    return (1.0 / s['u'], np.arccos(np.clip(s['c'], -1.0, 1.0)),
            s['t'].astype(np.float64) - s['t_c'].astype(np.float64),
            s['phi'], s['pm_r'], s['pm_th'])


def geos_table(geos):
    """(r, theta, t, phi, pm_r, pm_th) of a Geodesics, (rays, ngeo) each,
    and tau_final."""
    return (tuple(getattr(geos, f).reshape(-1, geos.ngeo) for f in
                  ('r', 'theta', 't', 'phi', 'pm_r', 'pm_th')),
            np.ravel(geos.tau_final))


def trace_gate(label, test, truth, tau_test, tau_truth, n_fine, fov,
               rmax=None, tau_max=4.0):
    """The drive's gate (drive_device_geos.compare) on a float32 table
    against another trace of the same rays, (r, theta, t, phi, pm_r,
    pm_th) of (rays, ngeo) each, with the domain r <= fov, and phi and the
    momentum signs beside it (compare_phi_signs: phi under t's bars, the
    signs equal on every sample of the rays whose terminal Mino time
    agrees). With rmax, for a model whose emission domain r <= rmax is
    narrower than its field of view, the domain of the gate is r <= rmax
    for every ray and r <= fov for the rays whose terminal Mino time
    agrees: a ray whose pass-1 termination lands one fine step (h =
    tau_max / n_fine) apart samples the same geodesic at Mino times up to
    h apart, which moves t at radius r by up to ~r^2 h (1.6 M at r = 40
    and n_fine 4096, 0.4 M at r = 20), and that is no error of the
    geodesic (flip_report shows where such a ray stops). Logs the numbers
    and the flipped rays; returns (ok, dict)."""
    from bhnerf_tpu_torch.scripts.drive_device_geos import (
        compare, compare_phi_signs, describe, describe_phi_signs)
    tau_test, tau_truth = np.ravel(tau_test), np.ravel(tau_truth)
    same = tau_test == tau_truth
    steps = np.abs(tau_test.astype(np.float64) - tau_truth) * n_fine / tau_max

    def gate(rays, domain):
        q = compare(tuple(x[rays] for x in test[:3]),
                    tuple(x[rays] for x in truth[:3]), domain)
        q_rest = compare_phi_signs(test[0][rays],
                                   tuple(x[rays] for x in test[3:]),
                                   tuple(x[rays] for x in truth[3:]),
                                   same[rays], domain)
        return ({**q, **q_rest, 'ok': q['ok'] and q_rest['ok']},
                f'{describe(q)}; {describe_phi_signs(q_rest)}')

    every = np.ones_like(same)
    out, text = gate(every, fov if rmax is None else rmax)
    out.update(same_tau_final=float(same.mean()),
               flipped_rays=int((~same).sum()),
               max_flip_steps=float(steps.max()))
    domain = '' if rmax is None else f' (domain r <= {rmax:g})'
    line = (f'{label}{domain}: {text}; tau_final the same on '
            f'{100 * same.mean():.2f}% of the rays, the others '
            f'{int((~same).sum())} rays at most {steps.max():.2f} fine '
            f'steps apart')
    if rmax is not None:
        q_same, text_same = gate(same, fov)
        out['same_tau_to_fov'] = q_same
        out['all_to_fov_in_domain_max_dt'] = compare(
            test[:3], truth[:3], fov)['in_domain_max_dt']
        out['ok'] = out['ok'] and q_same['ok']
        line += (f'; to r <= {fov:g} on the rays of the same tau_final: '
                 f'{text_same}; on all rays max |dt| '
                 f'{out["all_to_fov_in_domain_max_dt"]:.2e}')
    log(line)
    return out['ok'], out


def rk4_steps(tau_final, samples, n_fine, tau_max=4.0, substeps=8,
              first_substeps=512):
    """RK4 steps the trace of each ray takes, read off its output: pass 1
    exactly (a ray that stopped at step i took i + 1 steps, one that did
    not n_fine); pass 2 a segment's substeps wherever the ray's record
    moved over the segment (a frozen ray's does not), so at most one
    segment too many."""
    h = np.float32(tau_max / n_fine)
    tau = tau_final.cpu().numpy()
    pass1 = np.where(tau < np.float32(tau_max), np.rint(tau / h) + 1,
                     n_fine)
    records = np.stack([v.cpu().numpy() for v in samples.values()])
    moved = (records[:, 1:] != records[:, :-1]).any(axis=0)
    nsub = np.full(moved.shape[0], substeps)
    nsub[0] = first_substeps
    return pass1 + (nsub[:, None] * moved).sum(axis=0)


def trace_bound(steps, ngeo):
    """(bound_ms, bound_by, GFLOP) of one trace whose rays take `steps` RK4
    steps: RK4_OPS float32 operations a step at FP32_FLOPS, against the
    bytes of each ray's initial state and constants (9 floats) read once
    and its samples (7 floats each) and terminal time written once."""
    ops = RK4_OPS * float(np.sum(steps))
    nbytes = 4 * len(steps) * (9 + 1 + 7 * ngeo)
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', ops / 1e9)


def trace_kernel_check(label, alpha, beta, spin, n_fine, fov, device,
                       rmax=None):
    """The tracer kernel against its plain version (the float32 torch loop)
    on the same inputs on the card, for the screen points (alpha, beta) at
    NGEO samples and n_fine fine steps, on all seven fields it writes: the
    drive's gate with the domain r <= fov on (r, theta, t), phi under t's
    bars and the momentum signs equal on every sample of the rays of the
    same terminal Mino time (trace_gate, with rmax for a model whose
    emission domain is narrower than fov), the gate's p90 bars of dr/r
    (1e-4) and dtheta (1e-3) held at the 99th percentile, far field
    included, median |dt| and |dphi| < 2e-4, and the same terminal Mino
    time on >= 95% of the rays; the kernel's
    and the plain version's ms and the bound. Returns a dict of the
    numbers."""
    import torch
    from bhnerf_tpu_torch.geodesics import integrator

    state0, lam, eta = trace_state(alpha, beta, spin, device)
    kw = dict(r_o=1000.0, n_fine=n_fine, ngeo=NGEO)
    tau_k, s_k = integrator.trace_rays(state0, spin, lam, eta, **kw)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    tau_p, s_p = integrator.trace_rays_plain(state0, spin, lam, eta, **kw)
    stop.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(stop)
    ok, q = trace_gate(
        f'device trace kernel against plain, {label}, {lam.numel()} rays '
        f'x {NGEO}, n_fine {n_fine}', as_table(s_k), as_table(s_p),
        tau_k.cpu().numpy(), tau_p.cpu().numpy(), n_fine, fov, rmax)
    ms = cuda_ms(lambda: integrator.trace_rays(state0, spin, lam, eta, **kw))
    steps = rk4_steps(tau_k, s_k, n_fine)
    b_ms, b_by, gflop = trace_bound(steps, NGEO)
    log(f'device trace: kernel against plain, {label}: p99 dr/r '
        f'{q["p99_dr_rel"]:.2e} (< 1e-4), dtheta {q["p99_dtheta"]:.2e} '
        f'(< 1e-3); median |dt| {q["median_dt"]:.2e}, |dphi| '
        f'{q["median_dphi"]:.2e} (< 2e-4), '
        f'the same tau_final on {100 * q["same_tau_final"]:.2f}% of the '
        f'rays (>= 95%); kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; '
        f'{int(steps.sum())} RK4 steps (max {int(steps.max())} a ray), '
        f'bound {b_ms:.3f} ms ({b_by}: {gflop:.2f} GFLOP at '
        f'{FP32_FLOPS / 1e12:.0f} TFLOP/s), kernel at '
        f'{100 * b_ms / ms:.1f}% of it')
    if not ok or q['p99_dr_rel'] >= 1e-4 or q['p99_dtheta'] >= 1e-3 \
            or q['median_dt'] >= 2e-4 or q['median_dphi'] >= 2e-4 \
            or q['same_tau_final'] < 0.95:
        raise RuntimeError(f'the tracer kernel disagrees with its plain '
                           f'version ({label})')
    return {'rays': int(lam.numel()), 'ngeo': NGEO, 'n_fine': n_fine,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
            'bound_by': b_by, 'rk4_steps': int(steps.sum()), **q}


def pass1_u_plain(alpha, beta, spin, n_fine, steps, dtype, device,
                  tau_max=4.0, r_o=1000.0, r_stop_factor=1.05):
    """u after each of the first `steps` pass-1 steps of the plain version
    (integrator._rk4_step in a torch loop, as terminal_mino_time steps a
    ray short of its stop) in `dtype` on `device`, for the screen points
    (alpha, beta) at inclination 60 deg: (steps, rays)."""
    import torch
    from bhnerf_tpu_torch.geodesics import integrator
    state0, lam, eta = integrator.initial_state(
        np.ravel(alpha), np.ravel(beta), spin, np.deg2rad(60.0), r_o, dtype)
    s = integrator.RayState(*(x.to(device) for x in state0))
    lam, eta = lam.to(device), eta.to(device)
    h = torch.tensor(tau_max / n_fine, dtype=dtype, device=device)
    u_clip, _, u_floor = integrator._stop_constants(spin, r_o, r_stop_factor)
    us = []
    for _ in range(steps):
        s = integrator._rk4_step(s, h, spin, lam, eta, u_clip, u_floor)
        us.append(s.u)
    return torch.stack(us).cpu().numpy()


def pass1_u_kernel(alpha, beta, spin, n_fine, k, device, tau_max=4.0):
    """u of the kernel's pass 1 after k steps, for one screen point: pass 2
    of a launch with tau_max = k h, n_fine = k, ngeo 2 and first_substeps
    k takes the same k steps of the same h (a power of two, so k h / k is
    h) from the same state, with the escape stop moved to u = -inf so
    that pass 1 runs on. Pass 2 differs only in its freeze test and in
    its floor on u after a step (u_floor = u_escape / 2), and neither acts
    on a ray short of its stop nor on one that stops at the escape radius
    by a near tie. nan where pass 1 still stopped (at the horizon: moving
    that stop would move the clamp of the right-hand side with it)."""
    from bhnerf_tpu_torch.geodesics import integrator
    h = tau_max / n_fine
    state0, lam, eta = trace_state(alpha, beta, spin, device)
    stops = integrator._stop_constants
    integrator._stop_constants = lambda *a: (stops(*a)[0], -np.inf,
                                             stops(*a)[2])
    try:
        tau, samples = integrator.trace_rays(
            state0, spin, lam, eta, tau_max=k * h, n_fine=k, ngeo=2,
            first_substeps=k)
    finally:
        integrator._stop_constants = stops
    u = float(samples['u'][1, 0])
    return u if float(tau[0]) == np.float32(k * h) else float('nan')


def flip_report(label, alpha, beta, tau_dev, tau_host, spin, n_fine, device,
                tau_max=4.0, r_o=1000.0, r_stop_factor=1.05):
    """Where the rays whose terminal Mino time differs between the float32
    trace (tau_dev) and the host float64 one (tau_host) stop. alpha, beta:
    the host's screen points of the table, flattened. For each such ray,
    with i the earlier of the two stops (the 0-based pass-1 step whose
    result crossed), logs u after steps i - 1, i and i + 1 of the kernel,
    of its plain version (the float32 torch loop on the card) and of the
    host float64 loop, beside u_escape and u_clip, each as its distance
    to the stop it crosses in float32 ulps of that stop. A step past a
    version's own stop is one that its trace never takes. A flip is the
    one stop comparison landing on either side of a near tie: the check
    is that after step i the u of every version that shows it (the
    kernel's is hidden at the horizon, see pass1_u_kernel) lies within
    1e-4 of the stop, relative (the gate's accuracy of r), where a fine
    step moves u by
    about h near the escape radius (|du/dtau| -> 1 far out), the stop's
    own size. Returns (ok, list of dicts)."""
    import torch
    from bhnerf_tpu_torch.geodesics import integrator
    h = np.float32(tau_max / n_fine)
    tau_dev, tau_host = np.ravel(tau_dev), np.ravel(tau_host)
    rays = np.flatnonzero(tau_dev != tau_host)
    u_clip, u_escape, _ = (np.float32(x) for x in integrator._stop_constants(
        spin, r_o, r_stop_factor))
    if not len(rays):
        return True, []
    first = np.rint(np.minimum(tau_dev[rays], tau_host[rays]) / h).astype(int)
    n_steps = int(first.max()) + 2
    alpha, beta = np.ravel(alpha)[rays], np.ravel(beta)[rays]
    plain = pass1_u_plain(alpha.astype(np.float32), beta.astype(np.float32),
                          spin, n_fine, n_steps, torch.float32, device)
    host = pass1_u_plain(alpha, beta, spin, n_fine, n_steps, torch.float64,
                         'cpu')
    ok, out = True, []
    for j, (ray, i) in enumerate(zip(rays, first)):
        kernel = [pass1_u_kernel(alpha[j], beta[j], spin, n_fine, k, device)
                  for k in (i, i + 1, i + 2)]
        versions = {'kernel': kernel,
                    'plain f32': [float(x) for x in plain[i - 1:i + 2, j]],
                    'host f64': [float(x) for x in host[i - 1:i + 2, j]]}
        stop = (u_escape if versions['host f64'][1] ** 2 < u_escape * u_clip
                else u_clip)
        ulp = float(np.spacing(stop))
        near = {k: abs(v[1] - float(stop)) / float(stop)
                for k, v in versions.items() if np.isfinite(v[1])}
        ray_ok = ('host f64' in near and 'plain f32' in near
                  and all(x < 1e-4 for x in near.values()))
        ok = ok and ray_ok
        log(f'{label}: ray {ray} stops at step {int(round(tau_dev[ray] / h))} '
            f'on the card, {int(round(tau_host[ray] / h))} on the host; '
            f'u_escape {float(u_escape):.9e}, u_clip {float(u_clip):.9e}; '
            f'u after steps {i - 1} / {i} / {i + 1}, in float32 ulps '
            f'({ulp:.3e}) from the stop it crosses: '
            + '; '.join(f'{k} ' + ' / '.join(f'{(x - float(stop)) / ulp:+.1f}'
                                             for x in v)
                        for k, v in versions.items())
            + f'; after step {i} within {max(near.values()):.1e} of it, '
              f'relative (< 1e-4)')
        out.append({'ray': int(ray), 'step': int(i), 'stop': float(stop),
                    'ulp': ulp, 'u': versions, 'ok': ray_ok})
    return ok, out


def trace_kernel_time(label, alpha, beta, spin, n_fine, device,
                      inc=np.deg2rad(60.0), ngeo=NGEO):
    """The kernel's ms (CUDA events) on a screen (at inclination `inc`,
    ngeo samples a ray), its bound, and the latency floor: the kernel
    alone on the ray that takes the most RK4 steps (no table can be
    traced faster than its longest ray)."""
    from bhnerf_tpu_torch.geodesics import integrator
    state0, lam, eta = trace_state(alpha, beta, spin, device, inc)
    kw = dict(r_o=1000.0, n_fine=n_fine, ngeo=ngeo)
    tau, samples = integrator.trace_rays(state0, spin, lam, eta, **kw)
    ms = cuda_ms(lambda: integrator.trace_rays(state0, spin, lam, eta, **kw))
    steps = rk4_steps(tau, samples, n_fine)
    i = int(np.argmax(steps))
    one = integrator.RayState(*(x[i:i + 1].contiguous() for x in state0))
    floor_ms = cuda_ms(lambda: integrator.trace_rays(
        one, spin, lam[i:i + 1].contiguous(), eta[i:i + 1].contiguous(),
        **kw))
    b_ms, b_by, gflop = trace_bound(steps, ngeo)
    log(f'device trace {label}: {lam.numel()} rays x {ngeo}, n_fine '
        f'{n_fine}, one launch: kernel {ms:.3f} ms; {int(steps.sum())} RK4 '
        f'steps, bound {b_ms:.3f} ms ({b_by}: {gflop:.2f} GFLOP), kernel at '
        f'{100 * b_ms / ms:.1f}% of it; the longest ray alone '
        f'({int(steps[i])} steps) {floor_ms:.3f} ms, kernel at '
        f'{100 * floor_ms / ms:.1f}% of that floor')
    return {'rays': int(lam.numel()), 'n_fine': n_fine, 'ms': ms,
            'bound_ms': b_ms, 'bound_by': b_by, 'rk4_steps': int(steps.sum()),
            'latency_floor_ms': floor_ms, 'longest_ray_steps': int(steps[i])}


def device_trace_phase(t3_geos, t3_s, alma_host, eht, device):
    """The float32 device tracer: the kernel against its plain version at
    the drive's spin and on the main path's inputs (the ALMA ensemble);
    the float32 tables against the host float64 ones of the earlier
    phases (the Tutorial-3 table, the four ALMA tables of the same seed)
    and in the drive (bhnerf_tpu_torch.scripts.drive_device_geos); the
    hotspot lightcurve from the device table through image_plane_dynamics;
    20 ALMA 'lc' steps on the device-traced ensemble; kernel times and the
    wall seconds against the host's. Returns the kernel's JSON entry and
    the phase's summary."""
    import torch
    from bhnerf_tpu_torch import alma, emission, geodesics, units
    from bhnerf_tpu_torch.geodesics import image_plane_geos, integrator
    from bhnerf_tpu_torch.scripts import drive_device_geos as drive
    from bhnerf_tpu_torch.train.optimizer import TrainStep
    from bhnerf_tpu_torch.train.step import compact_ensemble_args

    t_phase = time.perf_counter()
    check_094 = trace_kernel_check(
        f'{TRACE_CHECK_RAYS}x{TRACE_CHECK_RAYS} spin 0.94',
        *screen(TRACE_CHECK_RAYS), 0.94, TRACE_CHECK_N_FINE, FOV, device)

    # the Tutorial-3 table on the card against the host one
    integrator.trace_rays.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g32 = image_plane_geos(spin=SPIN, inclination=np.deg2rad(60.0),
                           alpha_range=(-FOV / 2, FOV / 2),
                           beta_range=(-FOV / 2, FOV / 2), ngeo=NGEO,
                           num_alpha=NUM_RAYS, num_beta=NUM_RAYS,
                           n_fine=N_FINE, backend='device', device=device)
    t3_dev_s = time.perf_counter() - t0
    t3_launches = integrator.trace_rays.launches
    ok, _ = trace_gate(
        f'device trace Tutorial-3 {NUM_RAYS}x{NUM_RAYS}x{NGEO} (n_fine '
        f'{N_FINE}) against the host table', geos_table(g32)[0],
        geos_table(t3_geos)[0], g32.tau_final, t3_geos.tau_final, N_FINE,
        FOV)
    log(f'device trace Tutorial-3: trace_geodesics {t3_dev_s:.3f} s '
        f'({t3_launches} launch) against {t3_s:.2f} s on the host')
    flips_ok, flips = flip_report('device trace Tutorial-3 flip',
                                  t3_geos.alpha, t3_geos.beta, g32.tau_final,
                                  t3_geos.tau_final, SPIN, N_FINE, device)
    if not (ok and flips_ok) or t3_launches != 1:
        raise RuntimeError('device trace: the Tutorial-3 table fails the '
                           'gate')

    # the main path: the ALMA ensemble through get_raytracing_args, one
    # launch for all four tables, from the seed of the host ensemble
    integrator.trace_rays.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with alma_recorder() as dev:
        rts = alma.get_raytracing_args(
            np.deg2rad(60.0), ALMA_MODEL['spin'], ALMA_MODEL,
            stokes=('I', 'Q', 'U'), rot_angle=np.deg2rad(32.2 + 20.0),
            num_subpixel_rays=ALMA_RAYS, rng=np.random.default_rng(0),
            backend='device', device=device)
    torch.cuda.synchronize()
    dev['total_s'] = time.perf_counter() - t0
    launches = integrator.trace_rays.launches
    fov_alma = float(ALMA_MODEL['fov_M'])
    flips = {'tutorial3': flips}
    for v, (gd, gh) in enumerate(zip(dev['geos'], alma_host['geos'])):
        if not (np.array_equal(gd.alpha, gh.alpha.astype(np.float32))
                and np.array_equal(gd.beta, gh.beta.astype(np.float32))):
            raise RuntimeError(f'device trace: ALMA variant {v} has another '
                               f'screen than the host ensemble')
        ok, _ = trace_gate(
            f'device trace ALMA variant {v} (the host screen) against the '
            f'host table', geos_table(gd)[0], geos_table(gh)[0],
            gd.tau_final, gh.tau_final, ALMA_MODEL['n_fine'], fov_alma,
            rmax=fov_alma / 2)
        flips_ok, flips[f'alma_{v}'] = flip_report(
            f'device trace ALMA variant {v} flip', gh.alpha, gh.beta,
            gd.tau_final, gh.tau_final, ALMA_MODEL['spin'],
            ALMA_MODEL['n_fine'], device)
        if not (ok and flips_ok):
            raise RuntimeError(f'device trace: ALMA variant {v} fails the '
                               f'gate')
    log(f'device trace ALMA get_raytracing_args({ALMA_RAYS} variants): '
        f'{dev["total_s"]:.2f} s (trace {dev["trace_s"]:.3f} s in '
        f'{launches} launch, physics {dev["physics_s"]:.2f} s) against '
        f'{alma_host["total_s"]:.2f} s on the host (trace '
        f'{alma_host["trace_s"]:.2f} s, physics '
        f'{alma_host["physics_s"]:.2f} s)')
    if launches != 1 or len(dev['geos']) != ALMA_RAYS:
        raise RuntimeError(f'device trace: the ensemble took {launches} '
                           f'launches for {len(dev["geos"])} tables')

    summary = {'tutorial3': {'device_s': t3_dev_s, 'host_s': t3_s},
               'flips': flips,
               'alma_ensemble': {
                   'device': {k: dev[k] for k in
                              ('total_s', 'trace_s', 'physics_s')},
                   'host': {k: alma_host[k] for k in
                            ('total_s', 'trace_s', 'physics_s')}}}
    # the kernel against its plain version on the main path's inputs: the
    # ensemble's screens at its fine steps
    alpha_ens = np.stack([g.alpha for g in dev['geos']])
    beta_ens = np.stack([g.beta for g in dev['geos']])
    check = trace_kernel_check(
        f'the ALMA ensemble {ALMA_RAYS}x{NUM_RAYS}x{NUM_RAYS}', alpha_ens,
        beta_ens, ALMA_MODEL['spin'], ALMA_MODEL['n_fine'], fov_alma,
        device, rmax=fov_alma / 2)
    entry = {'name': 'geodesic_trace', 'route': 'cuda',
             'source': 'bhnerf_tpu_torch/ops/csrc/geodesic_trace.cu',
             'replaces': 'bhnerf_tpu/geodesics/integrator.py:123-215 (XLA '
                         'lax.scan)',
             'launches': launches, 'max_abs_err': check['in_domain_max_dt'],
             'max_abs_err_of': f't in M where r <= {fov_alma / 2:g} M',
             'max_rel_err_phi': check['in_domain_max_dphi'],
             'max_rel_err_phi_of': (f'phi over max(|phi|, 1) where r <= '
                                    f'{fov_alma / 2:g} M'),
             'sign_mismatches': (check['pm_r_mismatches']
                                 + check['pm_th_mismatches']),
             'sign_mismatches_of': ('pm_r and pm_th samples of the rays of '
                                    'the same tau_final'),
             'ms': check['ms'], 'plain_ms': check['plain_ms'],
             'bound_ms': check['bound_ms'], 'bound_by': check['bound_by'],
             'library_ms': None, 'check': check, 'check_spin_0.94': check_094}
    # the drive's tables at N_FINE, not its 8192
    with patched(geodesics, 'image_plane_geos',
                 lambda **kw: image_plane_geos(**kw, n_fine=N_FINE)):
        summary['drive'] = drive.drive(NUM_RAYS, device, log)
    summary['drive']['n_fine'] = N_FINE
    if not summary['drive']['ok']:
        raise RuntimeError('device trace: the drive fails the gate')

    # the hotspot's lightcurve from both Tutorial-3 tables
    hotspot = recovery_hotspot()
    t_frames = units.Quantity(np.linspace(0.0, 1.0, NT), 'hr')
    lcs = []
    for g in (t3_geos, g32):
        movie = emission.image_plane_dynamics(
            hotspot, g, g.keplerian_omega(), t_frames,
            -float(g.r_o + FOV / 4), t_start_obs=t_frames[0], device=device)
        lcs.append(movie.sum(dim=(-1, -2)).cpu().numpy())
    lc_rel = float(np.abs(lcs[1] - lcs[0]).max() / np.abs(lcs[0]).mean())
    log(f'device trace: recovery hotspot lightcurve ({NT} frames) from the '
        f'device table against the host one: max difference '
        f'{100 * lc_rel:.4f}% of the mean flux (< 1%)')
    if not lc_rel < 1e-2:
        raise RuntimeError('device trace: the lightcurve strays')
    summary['lightcurve_max_rel'] = lc_rel

    # 'lc' steps on the device-traced ensemble, through both fused kernels
    predictor, t_alma = alma_host['predictor'], alma_host['t_frames']
    crts = compact_ensemble_args(rts, predictor, layout='gather')
    movie = alma_target(predictor, {'gather': crts}, t_alma, device)
    lc_step = TrainStep.image(units.Quantity(t_alma, 'hr'),
                              movie.sum(axis=(-1, -2)), predictor,
                              sigma=np.asarray(ALMA_SIGMA), dtype='lc',
                              fused=True, device=device)
    alma_train("ALMA 'lc' fit on the device-traced ensemble, gather layout",
               lc_step, crts, predictor, device, STEPS)

    # kernel times: the drive's table at the reference's n_fine, the
    # production EHT table, the ALMA ensemble in one launch
    spin_drive = 0.94
    times = {
        'drive_64': trace_kernel_time(
            f'{NUM_RAYS}x{NUM_RAYS} spin {spin_drive}', *screen(NUM_RAYS),
            spin_drive, 8192, device),
        'eht_128': trace_kernel_time(
            f'{EHT_NPIX_PRODUCTION}x{EHT_NPIX_PRODUCTION} spin {SPIN}',
            *screen(EHT_NPIX_PRODUCTION), SPIN, N_FINE, device),
        'alma_ensemble': trace_kernel_time(
            f'ALMA ensemble {ALMA_RAYS}x{NUM_RAYS}x{NUM_RAYS}',
            alpha_ens, beta_ens, ALMA_MODEL['spin'], ALMA_MODEL['n_fine'],
            device)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g128 = image_plane_geos(spin=SPIN, inclination=np.deg2rad(60.0),
                            alpha_range=(-FOV / 2, FOV / 2),
                            beta_range=(-FOV / 2, FOV / 2), ngeo=NGEO,
                            num_alpha=EHT_NPIX_PRODUCTION,
                            num_beta=EHT_NPIX_PRODUCTION, n_fine=N_FINE,
                            backend='device', device=device)
    eht_dev_s = time.perf_counter() - t0
    eht_host_s = eht['npix128_f32']['geodesics_s']
    log(f'device trace {EHT_NPIX_PRODUCTION}x{EHT_NPIX_PRODUCTION}x{NGEO} '
        f'(n_fine {N_FINE}): trace_geodesics {eht_dev_s:.3f} s against '
        f'{eht_host_s:.2f} s on the host')
    if not np.isfinite(g128.r).all():
        raise RuntimeError('device trace: non-finite 128x128 table')
    summary['eht_128'] = {'device_s': eht_dev_s, 'host_s': eht_host_s}
    summary['kernel'] = times
    summary['phase_s'] = time.perf_counter() - t_phase
    log(f'device trace phase: {summary["phase_s"]:.1f} s')
    entry.update({'alma_ensemble': times['alma_ensemble'],
                  'drive_64_n_fine_8192': times['drive_64'],
                  'eht_128': times['eht_128'],
                  'tutorial3_launches': t3_launches})
    return entry, summary


def ring_differences(host, dev, mbar, n_fine, tau_max=4.0):
    """Rays whose mbar-th equatorial crossing (emission.equatorial_ring's
    sample) differs between a host float64 table and a float32 device
    table of the same screen, and what explains each: a terminal Mino time
    a fine step apart (the samples move), a cos(theta) whose sign the
    float32 table may read either way (|cos theta| within the two tables'
    difference at some sample: a crossing may appear or vanish), or a
    crossing whose two samples are equally near it within that difference
    (the nearer sample may swap). Returns the counts."""
    from bhnerf_tpu_torch.geodesics import equatorial
    f_h, i_h, n_h = equatorial.crossing_index(host, mbar)
    f_d, _, n_d = equatorial.crossing_index(dev, mbar)
    differ = (f_h != f_d) | (f_h & (n_h != n_d))
    step = lambda tau: np.rint(np.asarray(tau, np.float64) * n_fine / tau_max)
    flip = step(host.tau_final) != step(dev.tau_final)
    ct_h = np.cos(np.asarray(host.theta, np.float64))
    dc = np.abs(np.cos(np.asarray(dev.theta, np.float64)) - ct_h)
    sign = (np.abs(ct_h) <= dc).any(axis=-1)
    take = lambda a, i: np.take_along_axis(a, i[..., None], -1)[..., 0]
    tie = (np.abs(np.abs(take(ct_h, i_h)) - np.abs(take(ct_h, i_h + 1)))
           <= take(dc, i_h) + take(dc, i_h + 1))
    return {'rays': int(differ.size), 'crossing': int(f_h.sum()),
            'differ': int(differ.sum()),
            'flip': int((differ & flip).sum()),
            'sign': int((differ & ~flip & sign).sum()),
            'tie': int((differ & ~flip & ~sign & tie).sum()),
            'unexplained': int((differ & ~flip & ~sign & ~tie).sum())}


def synthetic_phase(kernels, t3_geos, device):
    """Synthetic sources, equatorial lensing and the synthetic-flare
    workflow. (a) rho_of_req at the reference's sizes on the device tracer
    (42 launches, every root found and checked on the host float64
    trace), the mbar = 1 ring against the photon ring, Gelles2021's
    face-on checks, and equatorial_ring on the Tutorial-3 device table
    against the host one; (b) generate_synthetic_lightcurves at its
    defaults for SYNTH_SOURCES, the movie rendered on the card, then
    fit_synthetic_lp_flares' sweep on the hotspot at its configuration
    (4x128, Q/U 'lc', batch 6, fused, chunks of 500) over SYNTH_INCS x one
    seed cut to SYNTH_STEPS steps, both kernels against their plain
    versions at its shapes, and chi2_df(backend='device') over its
    checkpoints; (c) the chi^2 example in its small mode on the device
    tracer. Fills the synthetic block of the JSON kernel entries and
    returns the phase's summary."""
    import torch
    import yaml
    from bhnerf_tpu_torch import alma, units, utils
    from bhnerf_tpu_torch.examples import gelles2021_polarized_ring as gelles
    from bhnerf_tpu_torch.examples import recovery_analysis_chi2_grid
    from bhnerf_tpu_torch.geodesics import equatorial, image_plane_geos
    from bhnerf_tpu_torch.geodesics import integrator
    from bhnerf_tpu_torch.ops import fused
    from bhnerf_tpu_torch.scripts import fit_alma_lp_apr11_sgra_flare
    from bhnerf_tpu_torch.scripts import fit_synthetic_lp_flares as fit
    from bhnerf_tpu_torch.scripts import generate_synthetic_lightcurves as gen
    from bhnerf_tpu_torch.train.logging import MemoryWriter

    t_phase = time.perf_counter()
    summary, trace_launches = {}, {}

    def traced(name, fn):
        integrator.trace_rays.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        trace_launches[name] = integrator.trace_rays.launches
        return out, time.perf_counter() - t0

    # (a) rho_of_req at the reference's defaults: 64 azimuths, 40
    # bisection steps, 400 samples a ray, n_fine 8192
    inc, req = np.deg2rad(20.0), 6.0
    (phis, rho), rho_s = traced('rho_of_req', lambda: equatorial.rho_of_req(
        0.0, inc, req, mbar=0, backend='device', device=device))
    t0 = time.perf_counter()
    r_host, _ = equatorial.r_equatorial(0.0, np.inf, inc, 0,
                                        rho * np.cos(phis),
                                        rho * np.sin(phis))
    host_s = time.perf_counter() - t0
    miss = float(np.nanmax(np.abs(r_host - req)))
    log(f'synthetic rho_of_req(0, 20 deg, {req:g} M, mbar 0) on the device '
        f'tracer: {len(phis)} azimuths, {trace_launches["rho_of_req"]} '
        f'launches in {rho_s:.2f} s, {int(np.isfinite(rho).sum())} roots '
        f'found, rho {np.nanmin(rho):.6f}..{np.nanmax(rho):.6f} M; the host '
        f'float64 trace of those rays crosses at r within {miss:.3e} M of '
        f'req (bar {1e-2 * req:g} M, {host_s:.1f} s)')
    if trace_launches['rho_of_req'] != 42 or not np.isfinite(rho).all() \
            or not np.isfinite(r_host).all() or miss > 1e-2 * req:
        raise RuntimeError('synthetic: rho_of_req on the device tracer fails')
    # the kernel on the largest of those launches, the bracketing scan:
    # 48 screen radii x 64 azimuths, 400 samples a ray, n_fine 8192
    rho_grid = np.linspace(1.0, 12.0, 48)[:, None]
    scan_time = trace_kernel_time(
        'rho_of_req scan 48x64 at 20 deg', rho_grid * np.cos(phis),
        rho_grid * np.sin(phis), 0.0, 8192, device, inc=inc, ngeo=400)
    (_, rho1), rho1_s = traced('rho_of_req_mbar1', lambda:
                               equatorial.rho_of_req(
                                   0.0, np.deg2rad(0.01), req, mbar=1,
                                   ngeo=600, backend='device',
                                   device=device))
    ring_dev = float(np.nanmax(np.abs(rho1 - np.sqrt(27.0))))
    log(f'synthetic rho_of_req(0, 0.01 deg, {req:g} M, mbar 1): '
        f'{trace_launches["rho_of_req_mbar1"]} launches in {rho1_s:.2f} s, '
        f'max |rho - sqrt(27)| {ring_dev:.4f} M (< 0.35)')
    if not np.isfinite(rho1).all() or ring_dev >= 0.35:
        raise RuntimeError('synthetic: the mbar = 1 ring misses the photon '
                           'ring')
    golden, golden_s = traced('gelles_golden', lambda: gelles.golden_face_on(
        nphi=64, backend='device', device=device))
    log(f'synthetic Gelles2021 face-on checks on the device tracer '
        f'({trace_launches["gelles_golden"]} launches, {golden_s:.2f} s): '
        f'radial B EVPA {np.rad2deg(golden["radial_evpa_dev"]):.4f} deg, '
        f'toroidal B {np.rad2deg(golden["toroidal_evpa_dev"]):.4f} deg '
        f'(< 3), vertical B I ratio {golden["vertical_I_ratio"]:.4f} (< 0.2)')
    g32, _ = traced('tutorial3_table', lambda: image_plane_geos(
        spin=SPIN, inclination=np.deg2rad(60.0),
        alpha_range=(-FOV / 2, FOV / 2), beta_range=(-FOV / 2, FOV / 2),
        ngeo=NGEO, num_alpha=NUM_RAYS, num_beta=NUM_RAYS, n_fine=N_FINE,
        backend='device', device=device))
    rings = {}
    for mbar in (0, 1):
        rings[mbar] = ring_differences(t3_geos, g32, mbar, N_FINE)
        log(f'synthetic equatorial_ring(mbar {mbar}) on the Tutorial-3 '
            f'device table against the host one: {rings[mbar]}')
        if rings[mbar]['unexplained']:
            raise RuntimeError('synthetic: equatorial_ring differs where '
                               'the tables do not explain it')
    summary['equatorial'] = {
        'rho_of_req_s': rho_s, 'rho_of_req_launches':
            trace_launches['rho_of_req'], 'rho_scan_kernel': scan_time,
        'rho_host_check_s': host_s,
        'rho_max_miss_M': miss, 'rho_mbar1_max_dev': ring_dev,
        'gelles': golden, 'gelles_s': golden_s,
        'ring_differences': {str(k): v for k, v in rings.items()}}

    with tempfile.TemporaryDirectory() as root:
        # (b) the generator at its defaults, rendered on the card, the
        # sources' one screen traced once, at N_FINE
        outs, gen_s = {}, {}
        with memo_traces() as memo:
            for source in SYNTH_SOURCES:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[source] = gen.main(['--out', root, '--name', source,
                                         '--source', source])
                torch.cuda.synchronize()
                gen_s[source] = time.perf_counter() - t0
                lc = np.loadtxt(outs[source]['csv'], delimiter=',',
                                skiprows=1)
                flare = np.load(outs[source]['flare'])['data']
                log(f'synthetic generate_synthetic_lightcurves --source '
                    f'{source} (64x64x100 rays, 123 frames, fov 40 M, 60 '
                    f'deg): {gen_s[source]:.1f} s; I {lc[:, 1].min():.4f}..'
                    f' {lc[:, 1].max():.4f} Jy, |Q|+|U| max '
                    f'{np.abs(lc[:, 2:]).max():.4f} Jy, flare '
                    f'{flare.shape}')
                if lc.shape != (123, 4) or not np.isfinite(lc).all() \
                        or not np.abs(lc[:, 2:]).max() > 0 \
                        or flare.shape != (64, 64, 64):
                    raise RuntimeError(f'synthetic: bad {source} data')
        if memo.traced != 1:
            raise RuntimeError(f'synthetic: the generator traced '
                               f'{memo.traced} host tables, not 1')

        # the synthetic fit at its configuration, cut to SYNTH_STEPS steps
        raw = yaml.safe_load(fit.CONFIG_PATH.read_text())
        raw['optimization']['hparams']['num_iters'] = SYNTH_STEPS
        cfg_path = os.path.join(root, 'recovery.yaml')
        with open(cfg_path, 'w') as f:
            yaml.dump(raw, f)
        trace = {'ngeo': NGEO, 'n_fine': N_FINE}
        fused.render_fwd.launches = fused.render_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = fit.run_sweep(outs['hotspot']['yaml'], list(SYNTH_INCS),
                                [1], MemoryWriter, config_path=cfg_path,
                                device=device, model_overrides=trace,
                                verbose=False)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = (fused.render_fwd.launches, fused.render_bwd.launches)
        f = records[0]['fit']
        n_train, opt_cfg = len(f['train']['t']), f['opt_cfg']
        truth = f['emission_flare'].data
        zeros_psnr = utils.psnr(truth, torch.zeros_like(truth))
        logs = SYNTH_STEPS // opt_cfg.log_period
        expected = (len(SYNTH_INCS) * (SYNTH_STEPS
                                       + logs * -(-n_train // 20)),
                    len(SYNTH_INCS) * SYNTH_STEPS)
        fits = {}
        for r in records:
            w = r['writer']
            losses = [v for _, v in w.scalars['log_loss/train']]
            psnr = w.scalars['emission/psnr']
            first, last = np.mean(losses[:20]), np.mean(losses[-20:])
            fits[str(r['inclination'])] = {
                'log10_loss_first20': first, 'log10_loss_last20': last,
                'psnr': psnr, 'datafit': w.scalars['datafit/training']}
            log(f'synthetic fit {r["run"]}: steps {r["first_step"]}..'
                f'{r["last_step"]}, mean log10 training loss of the first 20'
                f' steps {first:.4f} -> last 20 {last:.4f}; psnr against the'
                f' flare {psnr} (a field of zeros {zeros_psnr:.4f} dB), '
                f'datafit {w.scalars["datafit/training"]}')
            if (r['first_step'], r['last_step']) != (1, SYNTH_STEPS) \
                    or len(losses) != SYNTH_STEPS \
                    or not np.isfinite(losses).all() or not last < first \
                    or not np.isfinite([v for _, v in psnr]).all():
                raise RuntimeError(f'synthetic: bad fit {r["run"]}')
        log(f'synthetic fit_synthetic_lp_flares sweep: {len(records)} runs '
            f'of {SYNTH_STEPS} steps in chunks of {opt_cfg.scan_chunk} '
            f'({n_train} training frames, stokes {f["stokes"]}, batch '
            f'{opt_cfg.batchsize}) in {sweep_s:.1f} s with the host traces; '
            f'launches fwd {launches[0]}, bwd {launches[1]} (expected '
            f'{expected})')
        if len(records) != len(SYNTH_INCS) or launches != expected:
            raise RuntimeError(f'synthetic: {len(records)} runs, launches '
                               f'{launches}')
        checks = {}
        t_train = np.asarray(f['train']['t'], np.float32)
        for r in records:
            opt = r['optimizer']
            crt = opt.raytracing_args[0]
            for batch in (BATCH, 20):
                c = recovery_kernel_checks(
                    opt.predictor, crt, t_train, device,
                    label=f'synthetic fit inc {r["inclination"]:g}',
                    dtypes=('float32',), batch=batch)
                checks[f'inc_{r["inclination"]:g}_b{batch}'] = dict(
                    n=crt.coords.shape[1], float32=c['float32'])
        # chi^2 of both checkpoints from device-traced tables
        ckpt_fmt = str(f['recovery_dir'] / fit_alma_lp_apr11_sgra_flare
                       .RUN_NAME)
        df, chi2_s = traced('chi2_df', lambda: alma.chi2_df(
            list(SYNTH_INCS), f['model_params']['spin'], [1],
            dict(f['model_params'], **trace), ckpt_fmt,
            units.Quantity(f['train']['t'], 'hr'), f['train']['data'],
            stokes=f['stokes'], sigma=np.asarray(opt_cfg.sigma),
            checkpoint_name=f'checkpoint_{SYNTH_STEPS}', backend='device',
            device=device))
        chi2 = df.values
        log(f"synthetic chi2_df(backend='device') at step {SYNTH_STEPS} "
            f'({chi2_s:.1f} s, {trace_launches["chi2_df"]} tracer launches): '
            + ', '.join(f'inc {i:g}: {c:.6g}'
                        for i, c in zip(df.index, chi2[:, 0])))
        if chi2.shape != (len(SYNTH_INCS), 1) \
                or not np.isfinite(chi2).all() \
                or trace_launches['chi2_df'] != len(SYNTH_INCS):
            raise RuntimeError(f"synthetic: chi2_df(backend='device'): {df}")

        # (c) the chi^2 example's small mode on the device tracer
        df_small, small_s = traced('chi2_example', lambda:
                                   recovery_analysis_chi2_grid.main(
                                       os.path.join(root, 'chi2'),
                                       small=True, device_geos=True,
                                       device=device))
        log(f'synthetic recovery_analysis_chi2_grid --small --device-geos: '
            f'{small_s:.1f} s, {trace_launches["chi2_example"]} tracer '
            f'launches, chi^2 '
            + ', '.join(f'inc {i:g}: {c:.6g}' for i, c in
                        zip(df_small.index, df_small.values.mean(axis=1))))
    summary.update({
        'generate_s': gen_s, 'sweep_s': sweep_s, 'fits': fits,
        'zeros_psnr': zeros_psnr,
        'fit_launches': {'fwd': launches[0], 'bwd': launches[1]},
        'chi2_device': {str(k): float(v) for k, v in zip(df.index,
                                                         chi2[:, 0])},
        'chi2_device_s': chi2_s,
        'chi2_example_small': {str(k): float(v) for k, v in zip(
            df_small.index, df_small.values.mean(axis=1))},
        'chi2_example_small_s': small_s,
        'trace_launches': trace_launches})
    summary['phase_s'] = time.perf_counter() - t_phase
    log(f'synthetic phase: {summary["phase_s"]:.1f} s')
    for i, (entry, kind) in enumerate(zip(kernels, ('fwd', 'bwd'))):
        entry['synthetic'] = {
            'launches': launches[i],
            **{name: dict(n=c['n'], float32=c['float32'][kind])
               for name, c in checks.items()}}
    return summary


def production_phase(kernels, device):
    """The ALMA production drive (bhnerf_tpu_torch.scripts.
    drive_alma_production) at full width and cut depth (PROD_STEPS steps,
    a PROD_ENSEMBLE-variant ensemble, the drive's ENSEMBLE for the call):
    leg 1 runs the fit script in a child process (--writer memory) on the
    seeded Apr11-like lightcurve and is sent SIGTERM once
    checkpoint_<save period> exists; leg 2 resumes it through --resume to
    PROD_STEPS; then chi^2 of the train and validation frames over a
    fresh ensemble of that size. Fails unless leg 2 resumed at leg
    1's stop, both chi^2 are finite and every training step launched one
    forward and one backward kernel. Then both kernels against their
    plain versions in float32 at the fit's N: variant 0 of the
    evaluation's ensemble, compacted as the fit compacts its ensemble.
    Fills the production block of the JSON kernel entries and returns the
    phase's summary."""
    import torch
    from bhnerf_tpu_torch.models.fields import NeRFPredictor
    from bhnerf_tpu_torch.scripts import drive_alma_production as prod
    from bhnerf_tpu_torch.train import compact_ensemble_args

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        ensemble, prod.ENSEMBLE = prod.ENSEMBLE, PROD_ENSEMBLE
        try:
            result, evaluation = prod.drive(
                PROD_STEPS, work, n_fine=PROD_N_FINE,
                log=lambda m: log(f'production {m}'))
        finally:
            prod.ENSEMBLE = ensemble
        run_dir = os.path.join(work, 'ckpt', 'inc_60.0.seed_4')
        predictor = NeRFPredictor.from_yml(run_dir)
    drive_s = time.perf_counter() - t_phase
    parts = result['launches']
    launches = {k: sum(p[k] for p in parts.values())
                for k in ('render_fwd', 'render_bwd', 'trace_rays')}
    stop = result['interrupt_step']
    log(f'production drive: {PROD_STEPS} steps, ensemble '
        f'{result["ensemble"]}, batch {result["batchsize"]}, SIGTERM at step '
        f'{stop}, resumed to {PROD_STEPS}; chi2 train '
        f'{result["chi2_train"]}, validation {result["chi2_val"]}; '
        f'{drive_s:.1f} s ({result["steps_per_sec_effective"]} steps/s '
        f'effective, evaluation {result["evaluate_s"]} s); launches '
        f'{parts} (n_fine {PROD_N_FINE})')
    train_bwd = (parts['leg1']['render_bwd'], parts['leg2']['render_bwd'])
    if not result['ok'] or result['ensemble'] != PROD_ENSEMBLE \
            or not 0 < stop < PROD_STEPS \
            or train_bwd != (stop, PROD_STEPS - stop) \
            or parts['leg1']['render_fwd'] <= stop \
            or parts['leg2']['render_fwd'] <= PROD_STEPS - stop \
            or parts['evaluate']['render_fwd'] == 0:
        raise RuntimeError(f'production drive: {result}')

    rts = evaluation['raytracing_args']
    crt = compact_ensemble_args(rts, predictor, layout='gather')[0]
    checks = recovery_kernel_checks(
        predictor, crt, np.asarray(evaluation['t_train'], np.float32),
        device, label='production variant 0', dtypes=('float32',))
    phase_s = time.perf_counter() - t_phase
    log(f'production phase: {phase_s:.1f} s')
    for entry, kind, key in zip(kernels, ('fwd', 'bwd'),
                                ('render_fwd', 'render_bwd')):
        entry['production'] = {'launches': launches[key],
                               'n': crt.coords.shape[1],
                               'float32': checks['float32'][kind]}
    return dict(result, drive_s=drive_s, phase_s=phase_s,
                n=crt.coords.shape[1], n_fine=PROD_N_FINE,
                launches_total=launches)


def multigpu_phase(kernels, geos, device):
    """The port's multi-GPU support (bhnerf_tpu_torch.parallel) at full
    width (lines starting `multigpu`): two ranks on this one card over
    gloo (NCCL refuses two ranks on one device), each a process of
    bhnerf_tpu_torch.scripts.drive_multigpu on a free localhost port, from
    the Tutorial-3 host table (Geodesics.save; no rank traces on the
    host) and one table of the ALMA ensemble traced here on the card, held
    against this process's one-process results on the same card: (a) the
    sharded device traces of the Tutorial-3 screen and of the 4-table ALMA
    ensemble equal the one-process traces bitwise; (b) the sample-parallel
    Tutorial-3 'full' step under mesh (1, 2) and (c) the frame
    data-parallel step under (2, 1), batch 6 as 3 + 3: images to rtol
    2e-5, loss to 2e-5 and gradients to 2e-4 (each with a floor of 1e-6 of
    the largest magnitude); (d) 200 chunked steps (chunks of 100) under
    each mesh track the one-process losses to rtol 2e-3; (e) the ALMA
    'lc' step with 3-Stokes weights under (1, 2) to the tolerances of (b);
    (f) rank 0 alone writes checkpoints, both ranks restore the same step
    and rank-local directories that disagree raise; (g) every rank
    launches the forward, backward and trace kernels, and the collectives
    of a step are one image all-reduce over 'ray' per forward and one
    all-reduce of the 55,169 gradients per step (with frames split, the
    loss over 'data'; the ALMA 'lc' gradient step sums its lightcurve
    alone over 'ray'), none sample-sized. Then one rank over NCCL: a
    Tutorial-3 step, an all-reduce and a broadcast of its gradients on the
    card. Two ranks share the card, so their step times are no scaling
    figure. Returns the phase's summary; adds each kernel's launches over
    the ranks to its JSON entry, and the kernels' checks against their
    plain versions at the ranks' shapes (multigpu_kernel_checks)."""
    import dataclasses as dc
    from bhnerf_tpu_torch.geodesics import Geodesics, trace_geodesics
    from bhnerf_tpu_torch.scripts import drive_multigpu as drive

    t_phase = time.perf_counter()
    inc = np.deg2rad(60.0)
    a_alpha, a_beta = drive.alma_screens(ALMA_MODEL, ALMA_RAYS, 0)
    t_alpha, t_beta = screen(NUM_RAYS)
    trace = {
        't3': dict(spin=SPIN, inclination=inc, ngeo=NGEO, n_fine=N_FINE,
                   alpha=t_alpha, beta=t_beta),
        'alma': dict(spin=ALMA_MODEL['spin'], inclination=inc, ngeo=NGEO,
                     n_fine=N_FINE, alpha=a_alpha, beta=a_beta)}
    ensemble = trace_geodesics(a_alpha, a_beta, backend='device',
                               device=device, **{
                                   k: v for k, v in trace['alma'].items()
                                   if k not in ('alpha', 'beta')})
    variant0 = dc.replace(ensemble, **{f: getattr(ensemble, f)[0]
                                       for f in Geodesics._FIELDS})
    t3 = dict(predictor=dict(scale=FOV / 2, rmin=3.0, rmax=FOV / 2,
                             z_width=2.0, net_depth=4, net_width=128,
                             posenc_deg=3),
              fov=FOV, nt=NT, span_M=200.0, batch=BATCH, seed=0, lr=1e-3)
    alma_cfg = dict(model=ALMA_MODEL, predictor=dict(
        net_depth=4, net_width=128, posenc_deg=3, learn_injection=True),
        rot_angle=float(np.deg2rad(32.2 + 20.0)), sigma=list(ALMA_SIGMA),
        nt=NT, seed=0)
    card = card_info()
    with tempfile.TemporaryDirectory() as work:
        config = drive.write_config(work, geos, variant0, t3, alma_cfg,
                                    trace, ('1x2', '2x1'), 200, 100)
        cfg = json.load(open(config))
        ref = drive.one_process(cfg, device)
        two = multigpu_ranks(config, 2, 'gloo')
        nccl = multigpu_ranks(config, 1, 'nccl', '--nccl-probe')
        records = [r for r, _ in two]
        arrays = [a for _, a in two]
    summary = multigpu_checks(ref, records, arrays, nccl, card)
    checks = multigpu_kernel_checks(cfg, geos, variant0, device)
    summary['kernel_checks'] = checks
    summary['phase_s'] = time.perf_counter() - t_phase
    log(f'multigpu phase: {summary["phase_s"]:.1f} s ({card})')
    for entry, kind, key in zip(kernels, ('fwd', 'bwd'),
                                ('render_fwd', 'render_bwd')):
        entry['multigpu_launches'] = [r['launches'][key] for r in records]
        entry['multigpu'] = {k: dict(c['float32'][kind], n=c['n'],
                                     frames=c['frames'])
                             for k, c in checks.items()}
    summary['trace_launches'] = [r['launches']['trace_rays']
                                 for r in records]
    return summary


def multigpu_kernel_checks(cfg, geos, alma_geos, device):
    """Both kernels against their plain versions in float32 at the shapes
    the ranks of multigpu_phase give them, built here in each rank's
    place (compact_raytracing_args with a Mesh of that rank's
    coordinates, no process group): each rank's Tutorial-3 block under
    mesh (1, 2) with 6 frames, the whole Tutorial-3 table with a rank's 3
    frames under (2, 1), and each rank's block of the ALMA table under
    (1, 2) with 6 frames and the frame-time cotangent of the learned
    injection time (its 3-Stokes weights enter after the kernels, in
    em @ W^T). Tolerances of recovery_kernel_checks. Returns {shape:
    {'n', 'frames', 'float32': {'fwd': ..., 'bwd': ...}}}."""
    from bhnerf_tpu_torch.parallel.mesh import Mesh
    from bhnerf_tpu_torch.scripts import drive_multigpu as drive
    from bhnerf_tpu_torch.train.step import compact_raytracing_args

    out = {}
    rt, predictor, t_frames = drive.t3_constants(cfg, geos, device)
    for r in range(2):
        crt = compact_raytracing_args(
            rt, predictor, mesh=Mesh({'data': 1, 'ray': 2}, rank=r))
        out[f'1x2 rank {r}'] = (crt, BATCH, predictor, t_frames, False)
    out['2x1'] = (compact_raytracing_args(rt, predictor), BATCH // 2,
                  predictor, t_frames, False)
    rt, predictor, t_frames = drive.alma_constants(cfg, alma_geos, device)
    for r in range(2):
        crt = compact_raytracing_args(
            rt, predictor, mesh=Mesh({'data': 1, 'ray': 2}, rank=r),
            layout='gather')
        out[f'alma 1x2 rank {r}'] = (crt, BATCH, predictor, t_frames, True)
    for k, (crt, frames, predictor, t_frames, want_dt) in out.items():
        checks = recovery_kernel_checks(
            predictor, crt, t_frames, device, label=f'multigpu {k}',
            dtypes=('float32',), batch=frames, want_dt=want_dt)
        out[k] = dict(checks, n=crt.coords.shape[1], frames=frames)
    return out


def multigpu_ranks(config, world, backend, *extra):
    """Run `world` ranks of drive_multigpu on cuda:0 over `backend`; every
    rank must exit 0. Returns each rank's (record, arrays)."""
    import socket
    work = os.path.dirname(config)
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE=str(world), LOCAL_RANK='0',
               MASTER_ADDR='localhost', MASTER_PORT=str(port),
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get('PYTHONPATH')) if p))
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'bhnerf_tpu_torch.scripts.drive_multigpu',
         '--config', config, '--backend', backend, '--device', 'cuda:0',
         *extra], env=dict(env, RANK=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f'multigpu rank {r}/{world} ({backend}) '
                               f'exited {p.returncode}:\n{out[-4000:]}')
    return [(json.load(open(os.path.join(work, f'rank_{r}.json'))),
             dict(np.load(os.path.join(work, f'rank_{r}.npz'))))
            for r in range(world)]


def multigpu_close(label, out, want, rtol):
    """The share of its tolerance that out's worst element takes against
    want: |out - want| <= rtol * |want| + a floor of 1e-6 of want's
    largest magnitude (np.allclose's form); raises above 1."""
    out, want = np.asarray(out, np.float64), np.asarray(want, np.float64)
    floor = 1e-6 * np.abs(want).max()
    share = float((np.abs(out - want) / (rtol * np.abs(want) + floor)).max())
    if not share <= 1.0:
        raise RuntimeError(f'multigpu {label}: {share:.3f} of the tolerance '
                           f'(rtol {rtol}, floor 1e-6 of the max)')
    return share


def multigpu_checks(ref, records, arrays, nccl, card):
    """(a)-(g) of multigpu_phase on the ranks' outputs; returns the
    summary."""
    images, loss, grads, _, _, ref_ms = ref['step']
    ref_losses, ref_chunk_ms = ref['chunks']
    n_params = sum(g.size for g in grads.values())
    image = images.size
    out = {'card': card, 'n_params': n_params, 'one_process_step_ms':
           ref_ms, 'one_process_chunk_step_ms': ref_chunk_ms,
           'one_process_trace_s': ref['trace_s'], 'ranks': []}
    # (a) the sharded traces
    bitwise = True
    for k, table in ref['tables'].items():
        for f in ('r', 'theta', 'phi', 't', 'pm_r', 'pm_th', 'tau_final'):
            a, b = arrays[0][f'trace/{k}/{f}'], np.asarray(getattr(table, f))
            same = np.array_equal(a, b, equal_nan=True)
            bitwise &= same
            if not same:
                multigpu_close(f'trace {k} {f}', a, b, 2e-6)
            digests = {r['trace_digest'][f'{k}/{f}'] for r in records}
            if len(digests) != 1:
                raise RuntimeError(f'multigpu trace {k} {f} differs across '
                                   f'ranks')
    log(f'multigpu (a) sharded device traces of the Tutorial-3 screen '
        f'{NUM_RAYS}x{NUM_RAYS}x{NGEO} and the {ALMA_RAYS}-table ALMA '
        f'ensemble (n_fine {N_FINE}) over 2 ranks: '
        f'{"bitwise" if bitwise else "within 2e-6 of"} the one-process '
        f'trace; {[round(r["trace_s"], 3) for r in records]} s a rank '
        f'(with the assembly), one process {ref["trace_s"]:.3f} s')
    out['trace_bitwise'] = bitwise
    # (b), (c) one step under each mesh
    for name in ('1x2', '2x1'):
        a = arrays[0]
        errs = dict(
            images=multigpu_close(f'{name} images', a[f'{name}/images'],
                                  images, 2e-5),
            loss=multigpu_close(f'{name} loss', a[f'{name}/loss'], loss,
                                2e-5),
            grads=max(multigpu_close(f'{name} grad {k}',
                                     a[f'{name}/grad/{k}'], v, 2e-4)
                      for k, v in grads.items()))
        for other in arrays[1:]:
            if float(other[f'{name}/loss']) != float(a[f'{name}/loss']) or \
                    any(not np.array_equal(other[f'{name}/grad/{k}'],
                                           a[f'{name}/grad/{k}'])
                        for k in grads):
                raise RuntimeError(f'multigpu {name}: ranks disagree')
        losses = a[f'{name}/chunk_losses']
        errs['chunk_losses'] = multigpu_close(f'{name} chunked losses',
                                              losses, ref_losses, 2e-3)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise RuntimeError(f'multigpu {name}: chunked losses {losses}')
        label = ('(b) sample-parallel' if name == '1x2'
                 else '(c) frame data-parallel')
        log(f'multigpu {label} Tutorial-3 step, mesh {name}, shares of the '
            f'tolerances taken: images {errs["images"]:.3f} (rtol 2e-5), '
            f'loss {errs["loss"]:.3f} (2e-5), gradients {errs["grads"]:.3f} '
            f'(2e-4); (d) {len(losses)} chunked steps: losses '
            f'{losses[0]:.6g} -> {losses[-1]:.6g}, {errs["chunk_losses"]:.3f} '
            f'of rtol 2e-3; local N '
            f'{[r["local_n"][name] for r in records]} (one process '
            f'{ref["local_n"]}); step ms per rank '
            f'{[round(r["step_ms"][name], 3) for r in records]}, chunked '
            f'{[round(r["step_ms"][name + "/chunks"], 3) for r in records]}'
            f'; one process {ref_ms:.3f} / {ref_chunk_ms:.3f} ms ({card}; '
            f'two ranks share one card: no scaling figure)')
        out[name] = errs
    # (e) ALMA 'lc'
    _, a_loss, a_grads, _, _, a_ms = ref['alma']
    a = arrays[0]
    e_err = dict(loss=multigpu_close('alma loss', a['alma/loss'], a_loss,
                                     2e-5),
                 grads=max(multigpu_close(f'alma grad {k}',
                                          a[f'alma/grad/{k}'], v, 2e-4)
                           for k, v in a_grads.items()))
    log(f"multigpu (e) ALMA 'lc' step with 3-Stokes weights, mesh 1x2, shares"
        f' of the tolerances taken: loss {e_err["loss"]:.3f} (rtol 2e-5), '
        f'gradients {e_err["grads"]:.3f} (2e-4; t_injection learned); step ms '
        f'{[round(r["step_ms"]["alma 1x2"], 3) for r in records]}, one '
        f'process {a_ms:.3f}')
    out['alma'] = e_err
    # (f) checkpoints
    c0, c1 = (r['checkpoints'] for r in records)
    if c0['writes'] != [2, 4] or c1['writes'] != [] or \
            any(c['restored_step'] != 4 or 'checkpoint_4' not in
                c['listing'] or 'disagrees across' not in
                (c['disagree_error'] or '') for c in (c0, c1)):
        raise RuntimeError(f'multigpu checkpoints: {c0} {c1}')
    log(f'multigpu (f) checkpoints: rank 0 wrote steps {c0["writes"]}, rank 1 '
        f'none; both restored step 4; rank-local directories raised on both')
    # (g) launches and the census; the ALMA test step sums its 3-Stokes
    # images with the lightcurve, its gradient step the lightcurve alone
    lightcurve = BATCH * 3
    bound = BATCH * 3 * NUM_RAYS ** 2 + lightcurve
    expect = {
        '1x2/forward': {'image over ray': {'count': 1, 'largest': image}},
        '1x2/step': {'image over ray': {'count': 1, 'largest': image},
                     'grad over ray': {'count': 1, 'largest': n_params}},
        '2x1/forward': {},
        '2x1/step': {'grad over data': {'count': 1, 'largest': n_params},
                     'loss over data': {'count': 1, 'largest': 1}},
        'alma 1x2/forward': {'image over ray': {'count': 1,
                                                'largest': bound}},
        'alma 1x2/step': {
            'lightcurve over ray': {'count': 1, 'largest': lightcurve},
            'grad over ray': {'count': 1, 'largest': n_params + 1}}}
    for r in records:
        for k, want in expect.items():
            if r['census'][k] != want:
                raise RuntimeError(f'multigpu census {k}: {r["census"][k]}')
        training = [v for k, c in r['census'].items() if k != 'trace'
                    for v in c.values()]
        if max(v['largest'] for v in training) > max(bound, n_params + 1):
            raise RuntimeError(f'multigpu: a collective is sample-sized: '
                               f'{r["census"]}')
        if min(r['launches'].values()) <= 0:
            raise RuntimeError(f'multigpu rank {r["rank"]} launched no '
                               f'kernel of {r["launches"]}')
        out['ranks'].append({k: r[k] for k in ('rank', 'launches', 'census',
                                               'step_ms', 'local_n',
                                               'trace_s', 'seconds')})
    log(f'multigpu (g) launches per rank {[r["launches"] for r in records]};'
        f' census of rank 0: {records[0]["census"]}')
    # one rank over NCCL
    record, nccl_arrays = nccl[0]
    if record['nccl_backend'] != 'nccl' or not record['nccl_identity'] or \
            not np.isfinite(record['loss']):
        raise RuntimeError(f'multigpu NCCL rank: {record}')
    multigpu_close('NCCL step images', nccl_arrays['nccl/images'], images,
                   2e-5)
    log(f'multigpu NCCL: one rank initialised on the card, a Tutorial-3 step '
        f'({record["step_ms"]["1x1"]:.3f} ms, loss {record["loss"]:.6g}), '
        f'an all-reduce and a broadcast of {record["nccl_elements"]} '
        f'gradients on the card (identity for one rank)')
    out['nccl'] = {k: record[k] for k in ('nccl_backend', 'nccl_identity',
                                          'nccl_elements', 'loss',
                                          'step_ms', 'launches')}
    return out


def memo_traces(seed=None):
    """A context in which dataset.trace_geodesics traces at N_FINE fine
    steps (the tutorials' own: the trace defaults' 8192, and 8192 in
    recovery_animation) and traces a screen once, the screen keyed by its
    alpha and beta, spin, inclination, ngeo and backend (the tutorials
    vary nothing else). `seed`, a host table at N_FINE (the Tutorial-3
    table of host_precompute, whose screen tutorials 2 and 3 and
    recovery_animation trace), is entered first. `calls` and `traced`
    count the calls and the traces."""
    from bhnerf_tpu_torch.geodesics import dataset

    def key(alpha, beta, spin, inclination, ngeo, backend):
        return (np.asarray(alpha, np.float64).tobytes(),
                np.asarray(beta, np.float64).tobytes(), float(spin),
                float(inclination), int(ngeo), backend)

    class Memo:
        def __enter__(self):
            self.trace = dataset.trace_geodesics
            self.cache = {} if seed is None else {
                key(seed.alpha, seed.beta, seed.spin, seed.inc, seed.ngeo,
                    'cpu'): seed}
            self.calls = self.traced = 0

            def traced(alpha, beta, spin, inclination, **kw):
                kw['n_fine'] = N_FINE
                self.calls += 1
                k = key(alpha, beta, spin, inclination, kw.get('ngeo', 100),
                        kw.get('backend', 'cpu'))
                if k not in self.cache:
                    self.traced += 1
                    self.cache[k] = self.trace(alpha, beta, spin,
                                               inclination, **kw)
                return self.cache[k]

            dataset.trace_geodesics = traced
            return self

        def __exit__(self, *exc):
            dataset.trace_geodesics = self.trace
            return False

    return Memo()


def compositor_check(label, composite, full, device, stride=8):
    """One volume compositor at a tutorial's full shape on the card: its
    mean ms (CUDA events), the device memory it takes at its peak beyond
    what was allocated before it, and its outputs against the same
    function on the CPU at every stride-th pixel of each image axis, each
    within 2e-4 of its maximum (tests/test_torch_visualization.py's
    bound against the JAX package). composite(device, stride) runs it on
    `device` over the sub-sampled pixels."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    card = composite(device, 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    ms = cuda_ms(lambda: composite(device, 1), repeats=5)
    cpu = composite('cpu', stride)
    errs = []
    for c, h in zip(card, cpu):
        c = c[::stride, ::stride].cpu().numpy()
        h = h.numpy()
        scale = float(np.abs(h).max())
        if c.shape != h.shape or not np.isfinite(c).all():
            raise RuntimeError(f'{label}: bad outputs {c.shape}')
        errs.append(float(np.abs(c - h).max()) / scale if scale else
                    float(np.abs(c).max()))
    pixels = tuple(card[0].shape)
    log(f'tutorials compositor {label}: {pixels[0]}x{pixels[1]} pixels x '
        f'{full} samples on the card in {ms:.3f} ms, peak '
        f'{peak / 2**20:.1f} MiB beyond its inputs; against the CPU at '
        f'every {stride}th pixel: max error {max(errs):.3e} of each '
        f"output's maximum (bound 2e-4)")
    if max(errs) > 2e-4:
        raise RuntimeError(f'{label}: the card differs from the CPU: {errs}')
    return {'pixels': pixels, 'samples': full, 'ms': ms,
            'peak_bytes': int(peak), 'max_rel_err_vs_cpu': max(errs)}


def compositor_checks(volumes, device):
    """Both volume compositors at the full shapes of tutorial 5 (384x384
    pixels x 192 samples) and recovery_animation (256x256 x 160), on the
    volume each rendered: _vv_composite with the BH sphere and the cube,
    as they call it, and _transfer_composite with ipyvolume_3d's default
    camera and transfer nodes."""
    import torch
    from bhnerf_tpu_torch import visualization as vis
    out = {}
    for name, res, samples, bh, vol in (
            ('tutorial5', 384, 192, 2.0, volumes['tutorial5']),
            ('recovery_animation', 256, 160, 1.0 + np.sqrt(1 - SPIN ** 2),
             volumes['recovery_animation'])):
        extent = FOV / 2

        def rays(fov, azimuth, zenith, distance, dev, stride):
            cam, dirs = vis.VolumeVisualizer(
                (res, res), fov=fov, device='cpu')._rays(azimuth, zenith,
                                                         distance)
            return cam.to(dev), dirs[::stride, ::stride].contiguous().to(dev)

        def vv(dev, stride):
            distance = 3.0 * extent
            cam, dirs = rays(35.0, 0.8, np.pi / 3, distance, dev, stride)
            t0, t1 = distance - 1.8 * extent, distance + 1.8 * extent
            ts = torch.as_tensor(np.linspace(t0, t1, samples).astype(
                np.float32)).to(dev)
            return vis._vv_composite(
                torch.as_tensor(vol).to(dev), cam, dirs, ts,
                (t1 - t0) / samples, extent, 300.0, bh, 0.012 * extent, 0.85,
                draw_cube=True, has_bh=True)

        def transfer(dev, stride):
            distance = 2.5 * 2 * extent
            cam, dirs = rays(45.0, 0.0, np.deg2rad(150.0), distance, dev,
                             stride)
            t0, t1 = distance - 1.8 * extent, distance + 1.8 * extent
            ts = torch.as_tensor(np.linspace(t0, t1, samples).astype(
                np.float32)).to(dev)
            nodes = [torch.tensor(x).to(dev) for x in
                     ((0.0, 0.2, 0.7), (0.0, 0.2, 0.3))]
            return vis._transfer_composite(
                torch.as_tensor(vol).to(dev), float(vol.max()), cam, dirs,
                ts, (t1 - t0) / samples, extent, *nodes)

        out[name] = {
            '_vv_composite': compositor_check(f'_vv_composite {name}', vv,
                                              samples, device),
            '_transfer_composite': compositor_check(
                f'_transfer_composite {name}', transfer, samples, device)}
    return out


def tutorials_phase(kernels, geos, device):
    """The five tutorials and the last two examples of the port
    (bhnerf_tpu_torch.tutorials, bhnerf_tpu_torch.examples.
    recovery_animation and selfcal_known_corruption) at full width
    (small=False: 64x64 rays, 4x128, 64 frames), in this process on the
    card, in a temporary directory, their host tables at N_FINE and each
    screen traced once (memo_traces, seeded with the Tutorial-3 table
    `geos`). Fails unless tutorial 3 reaches RECOVERY_MIN_PSNR through the
    reference's plain render, tutorial 4's TUTORIAL4_STEPS losses are finite
    and fall, tutorial 5 renders tutorial 3's checkpoint, recovery_animation
    launches the backward kernel once a step of its 1000 and the forward at
    least as often, plus one a batch of its movie render, and composites its
    24 views, and the full self-calibration is exact (below 1e-9); then both
    kernels against their plain versions at recovery_animation's N in
    float32, and both volume compositors at tutorial 5's and
    recovery_animation's full shapes against the CPU (compositor_checks).
    Fills the tutorials block of the JSON kernel entries and returns the
    phase's summary."""
    import torch
    from bhnerf_tpu_torch.examples import (recovery_animation,
                                           selfcal_known_corruption)
    from bhnerf_tpu_torch.ops import fused
    from bhnerf_tpu_torch.tutorials import (
        tutorial1_kerr_geodesics as t1,
        tutorial2_synthesize_ngeht_observations as t2,
        tutorial3_estimate_emission_image_plane as t3,
        tutorial4_estimate_emission_eht as t4,
        tutorial5_visualize_recovery as t5)

    t_phase = time.perf_counter()
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory() as work, memo_traces(geos) as memo:
        def run(name, main):
            fused.render_fwd.launches = 0
            fused.render_bwd.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = main(work, small=False, device=device)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            return result, (fused.render_fwd.launches,
                            fused.render_bwd.launches)

        r1, _ = run('tutorial1', t1.main)
        log(f'tutorials tutorial 1: table {r1["shape"]}, ISCO '
            f'{r1["isco"]:.4f} M, t {r1["t_range"][0]:.1f}..'
            f'{r1["t_range"][1]:.1f} M, {100 * r1["captured"]:.1f}% of the '
            f'rays captured, {seconds["tutorial1"]:.1f} s')
        if r1['shape'] != (NUM_RAYS, NUM_RAYS, NGEO) or \
                not np.isfinite(r1['t_range']).all() \
                or not 0 < r1['captured'] < 1:
            raise RuntimeError(f'tutorial 1: {r1}')

        r2, _ = run('tutorial2', t2.main)
        m = r2['mask']
        log(f'tutorials tutorial 2: movie {r2["movie"].shape} rendered on '
            f'the card, flux {r2["flux"][0]:.4g}..{r2["flux"][1]:.4g}; ngEHT '
            f'observation: {r2["nscan"]} scans, {r2["n_valid"]} valid '
            f'baselines, {seconds["tutorial2"]:.1f} s')
        if r2['movie'].shape != (NT, NUM_RAYS, NUM_RAYS) or \
                not np.isfinite(r2['movie']).all() or r2['n_valid'] == 0 \
                or not np.isfinite(r2['vis'][m]).all():
            raise RuntimeError('tutorial 2: bad movie or observation')

        r3, l3 = run('tutorial3', t3.main)
        log(f'tutorials tutorial 3: {r3["steps"]} plain steps at N = '
            f'{r3["n"]}, final loss {r3["final_loss"]:.6g}, psnr_3d '
            f'{r3["psnr_3d"]:.2f} dB (bar {RECOVERY_MIN_PSNR}), corr '
            f'{r3["corr"]:.4f}; fused launches {l3}; '
            f'{seconds["tutorial3"]:.1f} s')
        if not r3['psnr_3d'] >= RECOVERY_MIN_PSNR or l3 != (0, 0) \
                or r3['steps'] != 1000:
            raise RuntimeError(f'tutorial 3: {r3["psnr_3d"]:.2f} dB, {l3}')

        r5, _ = run('tutorial5', t5.main)
        views = r5['views']
        log(f'tutorials tutorial 5: {len(views)} views of '
            f'{views[0][0].shape} from the {r5["source"]}, '
            f'{seconds["tutorial5"]:.1f} s')
        if r5['source'] != 'checkpoint' or len(views) != 3 or not all(
                x.shape == (384, 384) and np.isfinite(x).all()
                for layers in views for x in layers) \
                or not min(layers[0].max() for layers in views) > 0:
            raise RuntimeError('tutorial 5: bad render')

        with patched(t4, 'NUM_ITERS', TUTORIAL4_STEPS):
            r4, l4 = run('tutorial4', t4.main)
        losses = r4['losses']
        log(f'tutorials tutorial 4: {losses.size} plain EHT steps, '
            f'{r4["nvis"]} visibilities, loss {losses[0]:.6g} -> '
            f'{losses[-1]:.6g}, psnr_3d {r4["psnr_3d"]:.2f} dB; fused '
            f'launches {l4}; {seconds["tutorial4"]:.1f} s')
        if losses.size != TUTORIAL4_STEPS or not np.isfinite(losses).all() \
                or not losses[-1] < losses[0] or l4 != (0, 0):
            raise RuntimeError(f'tutorial 4: {losses[[0, -1]]}, {l4}')

        ra, l_ra = run('recovery_animation', recovery_animation.main)
        fit, movie = ra['launches']['fit'], ra['launches']['movie']
        renders = -(-len(ra['t_frames']) // 8)
        n_ra = ra['crt'].coords.shape[1]
        log(f'tutorials recovery_animation: {ra["steps"]} fused steps in '
            f'chunks of 100 at N = {n_ra}, final loss '
            f'{ra["final_loss"]:.6g}; '
            f'launches fit {fit}, movie {movie}, total {l_ra}; '
            f'{len(ra["views"])} views of {ra["views"][0][0].shape}; '
            f'{seconds["recovery_animation"]:.1f} s')
        if ra['steps'] != 1000 or fit[1] != 1000 or fit[0] < 1000 \
                or movie != (renders, 0) \
                or l_ra != (fit[0] + movie[0], fit[1] + movie[1]) \
                or len(ra['views']) != 24 or not all(
                    x.shape == (256, 256) and np.isfinite(x).all()
                    for layers in ra['views'] for x in layers) \
                or not np.isfinite(ra['losses']).all():
            raise RuntimeError(f'recovery_animation: launches {l_ra}, '
                               f'{fit}, {movie}')

        sc, _ = run('selfcal', selfcal_known_corruption.main)
        errors = sc['vis_err']
        log(f'tutorials selfcal: median |vis error| / |vis| corrupted '
            f'{errors["corrupted"]:.6f}, D+feed calibrated '
            f'{errors["partial"]:.6f}, fully calibrated '
            f'{errors["calibrated"]:.3e} (< 1e-9); final losses '
            f'{ {k: float(v[-1]) for k, v in sc["chi2"].items()} }; '
            f'{seconds["selfcal"]:.1f} s')
        if not errors['calibrated'] < 1e-9 or not all(
                np.isfinite(v).all() for v in sc['chi2'].values()):
            raise RuntimeError(f'selfcal: {errors}')
    trace_calls, traced = memo.calls, memo.traced

    checks = recovery_kernel_checks(ra['predictor'], ra['crt'],
                                    ra['t_frames'], device,
                                    label='recovery_animation',
                                    dtypes=('float32',))
    compositors = compositor_checks(
        {'tutorial5': r5['volume'],
         'recovery_animation': ra['volume']}, device)
    for entry, kind, i in zip(kernels, ('fwd', 'bwd'), (0, 1)):
        entry['tutorials'] = {'n': n_ra, 'launches': l_ra[i],
                              'float32': checks['float32'][kind]}
    phase_s = time.perf_counter() - t_phase
    log(f'tutorials phase: {phase_s:.1f} s ({trace_calls} trace calls, '
        f'{traced} new host tables at n_fine {N_FINE})')
    return {'seconds': seconds, 'phase_s': phase_s,
            'host_tables': traced, 'trace_calls': trace_calls,
            'tutorial1': {k: r1[k] for k in ('isco', 'captured')},
            'tutorial2': {'nscan': r2['nscan'], 'n_valid': r2['n_valid']},
            'tutorial3': {k: r3[k] for k in ('psnr_3d', 'corr',
                                             'final_loss', 'n')},
            'tutorial4': {'loss_first': float(losses[0]),
                          'loss_last': float(losses[-1]),
                          'psnr_3d': r4['psnr_3d'], 'nvis': r4['nvis']},
            'recovery_animation': {'n': n_ra, 'launches': l_ra,
                                   'final_loss': ra['final_loss'],
                                   'movie_loss': ra['movie_loss']},
            'selfcal': errors, 'compositors': compositors}


# the reference's line of bench.py (:511-541): every key is printed, none
# null on the card
BENCH_KEYS = (
    'metric', 'value', 'unit', 'vs_baseline', 'steps_per_sec',
    'steps_per_sec_median', 'steps_per_sec_spread',
    'per_dispatch_steps_per_sec', 'scan_steps_per_sec',
    'scan_steps_per_sec_spread', 'baseline_dense_xla_steps_per_sec',
    'baseline_source', 'mlp_samples_per_sec', 'model_tflops', 'mfu',
    'peak_tflops', 'chip', 'compute_dtype', 'alma_steps_per_sec',
    'alma_steps_per_sec_spread', 'alma_ray_samples_per_sec',
    'alma_mlp_samples_per_sec', 'alma_mfu', 'alma_num_variants',
    'alma_shape', 'eht_steps_per_sec', 'eht_factored_steps_per_sec',
    'eht_nvis_per_frame', 'geos_device_trace_s')


@contextlib.contextmanager
def bench_tables(geos):
    """A context in which the benches' table cache and record lie in a
    temporary directory: the Tutorial-3 table `geos` where
    bhnerf_tpu_torch.bench (its headline table) and bench_recovery (at
    n_fine N_FINE) look for it, and bench_recovery's RECOVERY.json. The
    module globals come back on exit."""
    from bhnerf_tpu_torch import bench, bench_recovery
    with tempfile.TemporaryDirectory() as work, \
            patched(bench, 'CACHE_DIR', work), \
            patched(bench_recovery, 'RECOVERY_PATH',
                    os.path.join(work, 'RECOVERY.json')):
        for kind in ('bench', 'rec'):
            geos.save(bench.cache_path(kind, NUM_RAYS, NGEO, FOV, N_FINE))
        yield


def bench_phase(kernels, device):
    """bhnerf_tpu_torch.bench at full width with BENCH_REPS=1, on the
    Tutorial-3 table host_precompute traced (main caches it where the
    bench looks): every section, with the fused launch counts set to 0
    just before and read just after (one forward and one backward launch
    a fused step: 51 per-dispatch steps, the chunked section's warm-up
    chunk and 1000 steps, the ALMA shape's warm-up chunk and 600 steps,
    each EHT operator's warm-up chunk and 2 chunks; the device trace's
    two launches; none in the plain baseline); the line's keys, none null,
    its numbers finite; then both kernels against their plain versions in
    float32 and bfloat16 at the ALMA shape's N (the first variant of its
    synthetic ensemble, compacted with the other nine as the bench
    compacts them). Fills the bench block of the JSON kernel entries and
    returns the phase's summary."""
    import torch
    from bhnerf_tpu_torch import bench
    from bhnerf_tpu_torch.geodesics import integrator
    from bhnerf_tpu_torch.models.fields import NeRFPredictor
    from bhnerf_tpu_torch.ops import fused
    from bhnerf_tpu_torch.train.step import compact_ensemble_args

    t_phase = time.perf_counter()
    os.environ['BENCH_REPS'] = '1'
    fused.render_fwd.launches = 0
    fused.render_bwd.launches = 0
    integrator.trace_rays.launches = 0
    torch.cuda.synchronize()
    try:
        line = bench.run(device)
        torch.cuda.synchronize()
    finally:
        del os.environ['BENCH_REPS']
    launches = (fused.render_fwd.launches, fused.render_bwd.launches)
    want = 51 + 500 * (1 + 2) + 100 * (1 + 6) + 2 * 250 * (1 + 2)
    log(f'bench: {json.dumps(line)}')
    log(f'bench: launches fwd {launches[0]}, bwd {launches[1]} (expected '
        f'{want}), trace {integrator.trace_rays.launches} (expected 2)')
    if launches != (want, want) or integrator.trace_rays.launches != 2:
        raise RuntimeError('the bench did not go through the kernels once a '
                           'step')
    missing = [k for k in BENCH_KEYS if line.get(k) is None]
    numbers = [v for k, v in line.items() if not isinstance(v, str)
               and v is not None]
    if missing or line.get('power_limit_w') is None or not all(
            np.isfinite(v).all() for v in map(np.asarray, numbers)):
        raise RuntimeError(f'bench: null keys {missing} or non-finite '
                           f'numbers')

    # the ALMA shape's kernels: the headline predictor (rmin 3), the
    # bench's ten variants compacted together (padded to the largest), the
    # first of them; N as the bench's line gives it (its MLP samples a
    # step over batch 6), within its rounding of the steps/s
    predictor = NeRFPredictor(scale=FOV / 2, rmin=3.0, rmax=FOV / 2,
                              z_width=2.0, net_depth=4, net_width=128,
                              posenc_deg=3)
    crt = compact_ensemble_args(
        [bench.synthetic_polarized_rt(128, 100, 16.0, predictor, seed=s,
                                      device=device)
         for s in range(line['alma_num_variants'])], predictor,
        layout='gather')[0]
    n = crt.coords.shape[1]
    n_line = line['alma_mlp_samples_per_sec'] / (
        6 * line['alma_steps_per_sec'])
    log(f'bench ALMA shape: the check at N = {n}, the bench line\'s '
        f'{n_line:.0f}')
    if abs(n_line - n) > 1e-3 * n:
        raise RuntimeError(f'bench ALMA shape: the check runs at N = {n}, '
                           f'the bench at {n_line:.0f}')
    checks = recovery_kernel_checks(
        predictor, crt, np.linspace(0.0, 1.0, NT, dtype=np.float32), device,
        label='bench ALMA shape')
    for i, (entry, kind) in enumerate(zip(kernels, ('fwd', 'bwd'))):
        entry['bench'] = {'n': n, 'launches': launches[i],
                          **{dtype: c[kind] for dtype, c in checks.items()}}
    phase_s = time.perf_counter() - t_phase
    log(f'bench phase: {phase_s:.1f} s')
    return {'line': line, 'launches': launches, 'alma_shape_n': n,
            'phase_s': phase_s}


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false); this script runs only on the GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from bhnerf_tpu_torch.geodesics import integrator
    from bhnerf_tpu_torch.ops import _build, fused

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)
    # the card's name and power limit, as nvidia-smi gives them
    log(card_info())
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}')

    # one nvcc a source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(fused._lib), pool.submit(integrator._lib)]:
            job.result()
    log(f'build: fused_render.cu and geodesic_trace.cu built and loaded in '
        f'{time.perf_counter() - t0:.1f} s')
    for name in ('fused_render', 'geodesic_trace'):
        ptxas = _build.build_dir(name) / f'{name}.ptxas.log'
        if not ptxas.exists():
            continue
        for line in ptxas.read_text().splitlines():
            entry = re.search(r'((fused_render|geodesic_trace)_[a-z_]*'
                              r'kernel)(ILb1)?', line)
            if 'Compiling entry' in line and entry:
                log(f'  ptxas: {entry.group(1)}'
                    f'{" (bf16)" if entry.group(3) else ""}')
            elif 'registers' in line or 'spill' in line:
                log(f'  ptxas: {line.strip()}')

    geos, predictor, crt, t_frames, geos_s = host_precompute(device)
    kernels = kernel_checks(predictor, crt, t_frames, device)
    launches, opt, train_step, step_ms = train_main_path(
        predictor, crt, t_frames, device)
    profile_path('Tutorial-3', opt, train_step, crt, step_ms)
    alma_chunked, alma_host = alma_phase(kernels, device)
    with bench_tables(geos):
        recovery = recovery_phase(kernels, geos, device)
        fit_script = fit_script_phase(kernels, device)
        eht = eht_phase(kernels, device)
        trace_entry, device_trace = device_trace_phase(
            geos, geos_s, alma_host, eht, device)
        synthetic = synthetic_phase(kernels, geos, device)
        production = production_phase(kernels, device)
        multigpu = multigpu_phase(kernels, geos, device)
        tutorials = tutorials_phase(kernels, geos, device)
        bench_summary = bench_phase(kernels, device)
    trace_entry['production_launches'] = production['launches_total'][
        'trace_rays']
    trace_entry['fit_chi2_df_launches'] = fit_script['chi2_device_launches']
    trace_entry['synthetic_launches'] = synthetic['trace_launches']
    trace_entry['synthetic_rho_scan'] = synthetic['equatorial'][
        'rho_scan_kernel']
    trace_entry['multigpu_launches'] = multigpu['trace_launches']
    for entry, count in zip(kernels, launches):
        entry['launches'] = count
        entry['launches_per_step'] = count / STEPS
    kernels.append(trace_entry)
    print(json.dumps({'recovery': recovery}), flush=True)
    print(json.dumps({'scan': {
        'recovery_bf16_chunked': recovery['bfloat16_chunked'],
        'alma_lc_chunked': alma_chunked, 'fit_script': fit_script}}),
        flush=True)
    print(json.dumps({'eht': eht}), flush=True)
    print(json.dumps({'device_trace': device_trace}), flush=True)
    print(json.dumps({'synthetic': synthetic}), flush=True)
    print(json.dumps({'production': production}), flush=True)
    print(json.dumps({'multigpu': multigpu}), flush=True)
    print(json.dumps({'tutorials': tutorials}), flush=True)
    print(json.dumps({'bench': bench_summary}), flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
