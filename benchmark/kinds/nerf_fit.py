"""The system under test for configurations of kind `nerf_fit`: one fit of
the port's NeRF emission model to image-plane movies ('full') or to
polarized lightcurves ('lc'), built and driven through the port's own
entry points (`bhnerf_tpu_torch.train.Optimizer.run` over a `TrainStep`,
per step or in chunks), exactly as its fit scripts drive it.

`build` makes the geodesic tables, ray constants and compaction with the
port (timed as the `precompute` spans), the frame data and the initial
weights from the seed (`benchmark.inputs`), and the Optimizer. `Fit`
then runs the first three steps through the window's own call and keeps
what the check compares (`check_steps`), warms up the window's loop, and
runs the loop under a `Stop` that closes a window.
"""
from __future__ import annotations

import dataclasses
import signal
import time

import numpy as np
import torch

from benchmark import inputs

# the ray constants the table check and the reference read, per variant
DENSE_FIELDS = ('coords', 'Omega', 'J', 'g', 'dtau', 'Sigma', 't_geos_rel')


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


class Stop:
    """A callback of `Optimizer.run` that ends the run as a preemption
    does (SIGTERM at a step or chunk boundary, which the loop answers by
    returning) once `seconds` have passed since `start` or `max_steps`
    steps were taken. The close of the window waits for the device. With
    `step_times` every call waits for the device and keeps its time, so
    that each step's synchronized host time is known."""

    def __init__(self, device, seconds=None, max_steps=None,
                 step_times=False):
        self.device, self.seconds, self.max_steps = device, seconds, max_steps
        self.times = [] if step_times else None

    def start(self, optimizer):
        sync(self.device)
        self.step0 = optimizer.state.step
        self.t0 = time.perf_counter()
        self.t_end = self.steps = None
        self.marks = [self.t0]
        if self.times is not None:
            self.times = [self.t0]

    def __call__(self, optimizer):
        if self.times is not None:
            sync(self.device)
            self.times.append(time.perf_counter())
        self.marks.append(time.perf_counter())
        steps = optimizer.state.step - self.step0
        due = ((self.seconds is not None
                and time.perf_counter() - self.t0 >= self.seconds)
               or (self.max_steps is not None and steps >= self.max_steps))
        if due and self.t_end is None:
            sync(self.device)
            self.t_end = time.perf_counter()
            self.steps = steps
            signal.raise_signal(signal.SIGTERM)

    @property
    def elapsed(self):
        return self.t_end - self.t0

    @property
    def call_seconds(self):
        """Host seconds between the calls (chunks, or steps)."""
        return np.diff(self.marks).tolist()

    @property
    def step_seconds(self):
        """Each step's synchronized host time (step_times only)."""
        return np.diff(self.times).tolist()


class _Recorder:
    """The train step as the Optimizer sees it, keeping each call's frame
    indices, variant and loss (for the check steps only: reading them
    waits for the device)."""

    def __init__(self, train_step):
        self._ts = train_step
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._ts, name)

    def __call__(self, state, raytracing_args, indices, update_state=True,
                 variant=None):
        loss, state, images = self._ts(state, raytracing_args, indices,
                                       update_state=update_state,
                                       variant=variant)
        self.calls.append((torch.as_tensor(indices).cpu().clone(),
                           0 if variant is None else int(variant),
                           float(loss)))
        return loss, state, images


@dataclasses.dataclass
class Record:
    """What the first three steps of the program gave: each step's frame
    indices, variant and loss, the first gradient of every leaf as Adam
    holds it after step 1, and every leaf after step 3 (host float32, in
    the order of the parameters' state_dict)."""
    indices: list
    variants: list
    losses: list
    grad1: list
    params3: list


def _adam_first_gradient(optimizer):
    """g1 = m1 / (1 - beta1): Adam's first moment after one update from
    zero; a leaf without Adam state reads a gradient of zero."""
    sd = optimizer.state.opt.state_dict()
    beta1 = sd['param_groups'][0]['betas'][0]
    names = list(optimizer.params.state_dict())
    order = [i for g in sd['param_groups'] for i in g['params']]
    out = []
    for name, i in zip(names, order):
        st = sd['state'].get(i, {})
        p = optimizer.params.state_dict()[name]
        m = st.get('exp_avg', torch.zeros_like(p))
        out.append((m / (1.0 - beta1)).detach().float().cpu())
    return out


class Fit:
    def __init__(self, cfg, traffic, seed, device, predictor, train_step,
                 rt, dense, optimizer, weights0, t_frames, target, axes):
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.predictor, self.train_step, self.rt = predictor, train_step, rt
        self.dense, self.optimizer = dense, optimizer
        self.weights0, self.t_frames, self.target = weights0, t_frames, target
        self.axes = axes
        self.batch = traffic['batch']
        self.chunk = traffic['chunk'] if traffic['loop'] == 'chunked' else 0

    def run(self, num_iters, log_fns=()):
        """The window's call: Optimizer.run over the train step, per step
        or in chunks as the traffic says, `num_iters` steps at most."""
        self.optimizer.num_iters = num_iters
        self.optimizer.run(self.batch, self.train_step, self.rt,
                           log_fns=list(log_fns), verbose=False,
                           scan_chunk=self.chunk)

    def check_steps(self):
        """Steps 1 (alone) and 2-3 through the window's call, recorded."""
        real = self.train_step
        self.train_step = rec = _Recorder(real)
        try:
            self.run(1)
            grad1 = _adam_first_gradient(self.optimizer)
            self.run(2)
        finally:
            self.train_step = real
        params3 = [p.detach().float().cpu().clone()
                   for p in self.optimizer.params.state_dict().values()]
        idx, var, loss = zip(*rec.calls)
        self.record = Record(list(idx), list(var), list(loss), grad1,
                             params3)
        return self.record

    def warm_up(self):
        """One chunk, or as many single steps as the traffic says."""
        self.run(self.chunk or self.traffic['warmup_steps'])

    def window(self, stop):
        """Run until `stop` closes the window; returns stop."""
        stop.start(self.optimizer)
        self.run(10**9, [stop])
        if stop.t_end is None:
            raise RuntimeError('the loop ended before its window closed')
        return stop

    def in_domain_samples(self):
        """In-domain samples a step renders per frame, averaged over the
        variants (the domain of the configuration over the program's
        sample positions; the benchmark's own count)."""
        c = self.cfg
        counts = []
        for d in self.dense:
            r2 = np.sum(d['coords'] ** 2, axis=0)
            keep = ((r2 >= inputs.rmin(c) ** 2) & (r2 <= (c['fov_M'] / 2) ** 2)
                    & (np.abs(d['coords'][2]) <= c['z_width']))
            counts.append(int(keep.sum()))
        return float(np.mean(counts))

    def free(self):
        """Drop the program's state and device memory."""
        self.optimizer = self.train_step = self.rt = None
        if torch.device(self.device).type == 'cuda':
            torch.cuda.empty_cache()


def predictor_of(cfg):
    from bhnerf_tpu_torch.models import NeRFPredictor
    rmax = cfg['fov_M'] / 2
    return NeRFPredictor(scale=rmax, rmin=inputs.rmin(cfg), rmax=rmax,
                         z_width=cfg['z_width'], net_depth=cfg['net_depth'],
                         net_width=cfg['net_width'],
                         posenc_deg=cfg['posenc_deg'],
                         compute_dtype=cfg['compute_dtype'])


def _ray_constants(cfg, variants, seed, device):
    """The port's ray constants of every variant: the tables by its
    tracer ('host' float64 or 'device' float32), then its physics."""
    from bhnerf_tpu_torch import units
    from bhnerf_tpu_torch.geodesics import image_plane_geos
    from bhnerf_tpu_torch.train import raytracing_args
    fov, inc = cfg['fov_M'], np.deg2rad(cfg['inclination_deg'])
    backend = {'host': 'cpu', 'device': 'device'}[cfg['tracer']]
    rng = inputs.stream(seed, inputs.JITTER)
    if cfg['physics'] == 'alma':
        from bhnerf_tpu_torch import alma
        model = {k: cfg[k] for k in (
            'fov_M', 'z_width', 'rmin', 'Q_frac', 'b_consts', 'Omega_dir',
            'Omega_frac', 'num_alpha', 'num_beta', 't_start_obs', 'ngeo',
            'n_fine')}
        return alma.get_raytracing_args(
            inc, cfg['spin'], model, rot_angle=np.deg2rad(cfg['rot_angle_deg']),
            num_subpixel_rays=variants, rng=rng, backend=backend,
            device=device)
    out = []
    for _ in range(variants):
        geos = image_plane_geos(
            cfg['spin'], inc, (-fov / 2, fov / 2), (-fov / 2, fov / 2),
            ngeo=cfg['ngeo'], num_alpha=cfg['num_alpha'],
            num_beta=cfg['num_beta'], n_fine=cfg['n_fine'],
            randomize_subpixel_rays=variants > 1, rng=rng, backend=backend,
            device=device)
        out.append(raytracing_args(
            geos, geos.keplerian_omega(), -float(geos.r_o + fov / 4),
            units.Quantity(cfg['t_start_obs'], 'hr'), device=device))
    return out


def _host_copy(rt):
    out = {}
    for f in DENSE_FIELDS:
        v = getattr(rt, f)
        out[f] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.float32(v))
    return out


def build(cfg, traffic, seed, device, span):
    """The Fit of configuration `cfg` under `traffic` from `seed`; `span`
    (a name -> context manager) times the port's precompute."""
    from bhnerf_tpu_torch import units
    from bhnerf_tpu_torch.train import (Optimizer, TrainStep,
                                        compact_ensemble_args)
    variants = traffic['variants']
    predictor = predictor_of(cfg)
    with span('precompute.tables_and_ray_constants'):
        rt_list = _ray_constants(cfg, variants, seed, device)
    dense = [_host_copy(rt) for rt in rt_list]
    with span('precompute.compaction'):
        crt = compact_ensemble_args(rt_list, predictor, layout=cfg['layout'])
    del rt_list
    t_frames = inputs.frame_times_hr(cfg)
    target = inputs.targets(cfg, seed)
    with span('train_step'):
        sigma = np.asarray(cfg['sigma'], np.float32)
        train_step = TrainStep.image(units.Quantity(t_frames, 'hr'), target,
                                     predictor, sigma=sigma, dtype=cfg['loss'],
                                     fused=True, device=device)
        hparams = dict(num_iters=cfg['num_iters'], lr_init=cfg['lr_init'],
                       lr_final=cfg['lr_final'], seed=int(seed))
        optimizer = Optimizer(hparams, predictor, crt, device=device)
    with span('weights'):
        weights0 = inputs.initial_weights(cfg, seed, device)
        state = {}
        for i, (w, b) in enumerate(weights0):
            state[f'mlp.layers.{i}.weight'] = w
            state[f'mlp.layers.{i}.bias'] = b
        optimizer.params.load_state_dict(state)
    return Fit(cfg, traffic, seed, device, predictor, train_step,
               crt if variants > 1 else crt[0], dense, optimizer,
               [(w.cpu(), b.cpu()) for w, b in weights0], t_frames, target,
               inputs.screen_axes(cfg, variants, seed))
