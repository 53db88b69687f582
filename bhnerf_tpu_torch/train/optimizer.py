"""Training orchestration: the Optimizer loop, TrainStep, frame batching.

PyTorch counterpart of `bhnerf_tpu/train/optimizer.py`:
`total_movie_loss` (:19-46), the SIGTERM scope `_GracefulShutdown`
(:49-88), `Optimizer` with its checkpoints, its per-step `run` loop and
non-finite guard, and its scan-chunked loop (:90-317), the composable
`TrainStep` over one set of ray constants or a sub-pixel ensemble of
them, with its image and EHT losses and the per-loss `scan_metas`
(:322-476), `TemporalBatchedArgs` (:483-575) and `LogFn` (:577).
Frame batches and, for an ensemble, the variant of each gradient step are
drawn on the host from the Optimizer's explicit `torch.Generator`, in the
same order by both loops; the full frame tensors live on the training
device and each step selects its batch there. The per-step loop uploads
one step's indices at a time; the chunked loop uploads a chunk's indices
once, from pinned memory, and reads one loss back per chunk.

Under a mesh (parallel.mesh; frame data-parallelism through
`TrainStep.image/eht(mesh=...)`, samples through ray constants in the
sample-parallel layout) every rank runs this loop: the generators are
seeded alike, so every rank draws the same batches and variants (`run`
checks the seed across ranks once), rank 0's parameters are broadcast
when a run starts, each step's gradients are summed over the ranks
(train.step.make_step_fns), and rank 0 alone writes checkpoints.
"""
from __future__ import annotations

import signal
import warnings

import numpy as np
import torch

from bhnerf_tpu_torch import tracing, units
from bhnerf_tpu_torch.parallel import mesh as mesh_lib
from bhnerf_tpu_torch.train import state as state_lib
from bhnerf_tpu_torch.train import step as step_lib


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def total_movie_loss(batchsize, state, train_step, raytracing_args,
                     return_frames=False):
    """Aggregate test loss over all movie frames in batchsize chunks
    (reference optimization.py:14-66); the last chunk holds the frames
    left over."""
    nt = train_step.args[0].num_frames
    frames, total_loss = [], 0.0
    for start in range(0, nt, batchsize):
        inds = np.arange(start, min(start + batchsize, nt))
        loss, _, images = train_step(state, raytracing_args, inds,
                                     update_state=False)
        total_loss += float(loss)
        if return_frames:
            frames.append(images.cpu().numpy())
    output = total_loss / nt
    if return_frames:
        output = (output, np.concatenate(frames))
    return output


def _fold_seed(seed, step):
    """A generator seed from (seed, step): the starting step folded into
    the run's seed, as jax.random.fold_in does in the reference."""
    return int(np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1)[0])


class _GracefulShutdown:
    """SIGTERM-aware scope (reference optimizer.py:49-88): a preempted job
    gets a SIGTERM and a grace period; the training loop polls
    `requested` at step boundaries and checkpoints and returns instead of
    dying mid-step. A no-op off the main thread, where a handler cannot
    be installed.

    Under a mesh the flag is each process's own, as in the reference
    (which does not share it across processes either): a SIGTERM must
    reach every rank, as torchrun sends it to all of them, and the ranks
    stop together only if it lands on each before the same step
    boundary. A rank that stops alone leaves the others waiting in the
    next step's collectives."""

    def __init__(self):
        self.requested = False
        self._prev = None
        self._registered = False

    def __enter__(self):
        def handler(signum, frame):
            self.requested = True

        try:
            # _prev may be None (a handler installed outside Python), so
            # _registered, not _prev, records whether ours is in place
            self._prev = signal.signal(signal.SIGTERM, handler)
            self._registered = True
        except ValueError:      # not the main thread
            self._registered = False
        return self

    def __exit__(self, *exc):
        if self._registered:
            # a None _prev cannot be restored: SIG_DFL keeps later
            # SIGTERMs terminating the process
            signal.signal(signal.SIGTERM, self._prev if self._prev is not None
                          else signal.SIG_DFL)
        return False


class Optimizer:
    """Gradient-descent loop (reference optimization.py:68-143). With a
    `checkpoint_dir` it resumes from the latest checkpoint there (the
    step count and the learning-rate schedule continue from it), writes
    the predictor's configuration beside it, and checkpoints every
    `save_period` steps (at the last step when save_period < 0), keeping
    the newest `keep`."""

    @tracing.traced('bhnerf.setup.optimizer')
    def __init__(self, hparams, predictor, raytracing_args, save_period=-1,
                 checkpoint_dir='', keep=5, device='cuda'):
        self.step = 0
        self.init_step = 0
        self.num_iters = hparams['num_iters']
        self.checkpoint_dir = checkpoint_dir
        self.save_period = self.num_iters if save_period < 0 else save_period
        self.keep = keep
        self.loss = np.inf
        self.variant = 0
        self.seed = hparams.get('seed', 1)
        self.predictor = predictor
        # one explicit generator draws the initial weights, then every
        # frame batch and ensemble variant
        self.generator = torch.Generator().manual_seed(self.seed)
        params = predictor.init_params(generator=self.generator,
                                       device=device)
        tx = state_lib.make_optimizer(
            num_iters=self.num_iters,
            lr_init=hparams.get('lr_init', 1e-4),
            lr_final=hparams.get('lr_final', 1e-6),
            lr_inject=hparams.get('lr_inject'))
        self.state = state_lib.TrainState.create(params, tx)
        if checkpoint_dir:
            self.state = state_lib.restore_checkpoint(checkpoint_dir,
                                                      self.state)
            if mesh_lib.process_rank() == 0:
                predictor.save_params(checkpoint_dir)

    def log(self):
        for log_fn in self.log_fns:
            log_fn(self)

    def save_checkpoint(self, force=False):
        """Checkpoint the state at the current step: every save_period
        steps, at the run's last step, or when forced (reference
        optimizer.py:121-126)."""
        if self.checkpoint_dir and (
                force or self.step % self.save_period == 0
                or self.step == self.final_step - 1):
            with tracing.span('bhnerf.loop.checkpoint'):
                state_lib.save_checkpoint(self.checkpoint_dir, self.state,
                                          self.step, keep=self.keep)

    @property
    def params(self):
        """The trained parameters (the NeRFParams module of the state)."""
        return self.state.params

    def run(self, batchsize, train_step, raytracing_args, log_fns=(),
            verbose=True, nan_check_period=1000, scan_chunk=0):
        """Training loop (reference optimization.py:123-139) with a
        periodic non-finite-loss guard (checking every step would force a
        host sync per step). raytracing_args may be a list, a sub-pixel
        ray ensemble: each step then trains on one variant drawn from the
        generator. A SIGTERM checkpoints the current step and returns; a
        KeyboardInterrupt returns (reference optimizer.py:178-200).

        scan_chunk > 0 runs up to `scan_chunk` steps per chunk, whose
        frame indices go to the device in one upload, and reads the loss
        back once per chunk (reference optimizer.py:128-315). Chunk
        boundaries align to every save_period and every LogFn.log_period
        > 1, so checkpoints and those callbacks fire at the per-step
        loop's steps; log_period == 1 callbacks are replayed from the
        chunk's losses and see end-of-chunk params; the non-finite guard
        and SIGTERM are checked once per chunk. As in the reference, an
        ensemble that stack_ensemble would refuse warns and takes the
        per-step loop. Both loops draw the same batches and variants from
        the same generator, so they give the same loss series.

        A run that starts after step 1 (a resumed or extended run) draws
        from a generator seeded by (seed, starting step), so that it does
        not replay the first run's batches (reference optimizer.py:
        212-215); a fresh run keeps drawing from the generator that drew
        its initial weights.

        Under a mesh (that of the train step's frames or of the ray
        constants) the run first checks with one all-reduce that every
        rank has the same seed, and raises RuntimeError if not, then
        broadcasts rank 0's parameters; the loss it reports is the global
        loss, the same on every rank."""
        try:
            with tracing.span('bhnerf.loop.run'):
                return self._run(batchsize, train_step, raytracing_args,
                                 log_fns, verbose, nan_check_period,
                                 scan_chunk)
        finally:
            tracing.at_step(None)

    def _run(self, batchsize, train_step, raytracing_args, log_fns, verbose,
             nan_check_period, scan_chunk):
        mesh = _mesh_of(train_step, raytracing_args)
        if mesh is not None:
            mesh_lib.check_same_seed(self.seed, mesh)
            mesh_lib.broadcast_parameters(self.state.params, mesh)
        self.init_step = self.state.step + 1
        self.final_step = self.init_step + self.num_iters
        self.log_fns = list(log_fns)
        self.train_step = train_step
        self.raytracing_args = raytracing_args
        rt_list = _as_list(raytracing_args)
        num_variants = len(rt_list)
        if self.init_step > 1:
            self.generator = torch.Generator().manual_seed(
                _fold_seed(self.seed, self.init_step))

        if scan_chunk and train_step.scan_metas is not None:
            try:
                step_lib.check_ensemble(rt_list)
            except ValueError as e:
                warnings.warn(f'ensemble not scannable ({e}); falling back '
                              f'to the per-step loop')
            else:
                return self._run_scan(batchsize, train_step, rt_list,
                                      scan_chunk, verbose, num_variants)

        report = max(1, self.num_iters // 10)
        try:
            with _GracefulShutdown() as shutdown:
                for self.step in range(self.init_step, self.final_step):
                    tracing.at_step(self.step)
                    with tracing.span('bhnerf.loop.step'):
                        self._step(batchsize, train_step, raytracing_args,
                                   num_variants)
                        if (nan_check_period
                                and self.step % nan_check_period == 0
                                and not self._finite('nan_check')):
                            warnings.warn(f'non-finite loss at step '
                                          f'{self.step}; stopping (the last '
                                          f'checkpoint is recoverable)')
                            return
                        with tracing.span('bhnerf.loop.callbacks'):
                            self.log()
                        self.save_checkpoint()
                        if shutdown.requested:
                            # preemption: persist this step and end the
                            # run; a new Optimizer on checkpoint_dir
                            # resumes it
                            self.save_checkpoint(force=True)
                            return
                        if verbose and \
                                (self.step - self.init_step + 1) % report == 0:
                            tracing.counters.add('host_syncs.report')
                            print(f'iteration {self.step}: loss '
                                  f'{float(self.loss):.6g}', flush=True)
        except KeyboardInterrupt:
            return

    def _finite(self, site):
        """Whether the last loss is finite: the non-finite guard, which
        waits for the card (counted as `host_syncs.<site>`)."""
        with tracing.span('bhnerf.loop.guard'):
            tracing.counters.add(f'host_syncs.{site}')
            return bool(torch.isfinite(self.loss).all())

    def _draw(self, batchsize, train_step, num_variants):
        """One step's frame batch and variant from the generator."""
        batch = train_step.args[0].sample(batchsize, self.generator)
        variant = (int(torch.randint(num_variants, (),
                                     generator=self.generator))
                   if num_variants > 1 else 0)
        return batch, variant

    def _step(self, batchsize, train_step, raytracing_args, num_variants):
        """One gradient step on a frame batch (and, for an ensemble, a
        variant) drawn from the generator."""
        with tracing.span('bhnerf.loop.draw'):
            batch, self.variant = self._draw(batchsize, train_step,
                                             num_variants)
        with tracing.span('bhnerf.loop.upload'):
            # a copy from pageable memory: on the card it waits for the
            # stream (counted whatever the device)
            tracing.counters.add('host_syncs.index_copy')
            tracing.counters.add('h2d.index_copy',
                                 batch.numel() * batch.element_size())
            batch = batch.to(train_step.args[0].device_args[0].device)
        self.loss, self.state, _ = train_step(
            self.state, raytracing_args, indices=batch, variant=self.variant)

    def _run_scan(self, batchsize, train_step, rt_list, scan_chunk, verbose,
                  num_variants):
        """The chunked loop (reference optimizer.py:202-256).

        Per-step LogFns (log_period == 1, the LogFn default) stay out of
        the boundary alignment: a period of 1 would clamp every chunk to
        one step. The chunk returns every step's loss, so they are
        replayed on the host from the chunk's losses and variants, and see
        end-of-chunk params; callbacks that read params should use
        log_period > 1."""
        per_step_fns = [f for f in self.log_fns
                        if getattr(f, 'log_period', None) == 1]
        chunk_fns = [f for f in self.log_fns if f not in per_step_fns]
        periods = [f.log_period for f in chunk_fns
                   if getattr(f, 'log_period', 0) > 0]
        if self.checkpoint_dir:     # the save gate is moot without one
            periods.append(self.save_period)
        periods = [p for p in periods if p > 0]

        def next_boundary(s):
            bounds = [(s // p + 1) * p for p in periods]
            return min(bounds) if bounds else self.final_step - 1

        try:
            with _GracefulShutdown() as shutdown:
                self._scan_loop(shutdown, batchsize, train_step, rt_list,
                                scan_chunk, num_variants, next_boundary,
                                verbose, per_step_fns, chunk_fns)
        except KeyboardInterrupt:
            return

    def _upload_indices(self, batches, device):
        """A chunk's (chunk, batchsize) frame indices on `device`: one
        copy, from pinned memory on the card, that does not block."""
        with tracing.span('bhnerf.loop.upload'):
            idx = torch.stack(batches).to(torch.int64)
            tracing.counters.add('h2d.chunk_upload',
                                 idx.numel() * idx.element_size())
            if device.type != 'cuda':
                return idx.to(device)
            return idx.pin_memory().to(device, non_blocking=True)

    def _chunk(self, train_step, rt_list, indices, variants):
        """One chunk: a gradient step of `train_step` on each row of the
        device tensor `indices` and variant of `variants` (host ints).
        Returns the steps' losses (chunk,) on the device; nothing is read
        back, copied from the host or synchronised."""
        losses = []
        for i, variant in enumerate(variants):
            loss, self.state, _ = train_step(self.state, rt_list, indices[i],
                                             variant=variant)
            losses.append(loss)
        return torch.stack(losses)

    def _scan_loop(self, shutdown, batchsize, train_step, rt_list, scan_chunk,
                   num_variants, next_boundary, verbose, per_step_fns,
                   chunk_fns):
        """Chunks up to the last step (reference optimizer.py:258-315)."""
        device = train_step.args[0].device_args[0].device
        report = max(1, self.num_iters // 10)
        step = self.init_step - 1
        while step < self.final_step - 1:
            chunk = min(scan_chunk, self.final_step - 1 - step,
                        next_boundary(step) - step)
            tracing.at_step(step + 1)
            with tracing.span('bhnerf.loop.chunk'):
                with tracing.span('bhnerf.loop.draw'):
                    draws = [self._draw(batchsize, train_step, num_variants)
                             for _ in range(chunk)]
                indices = self._upload_indices([b for b, _ in draws], device)
                variants = [v for _, v in draws]
                losses = self._chunk(train_step, rt_list, indices, variants)
            step += chunk
            self.step, self.loss, self.variant = step, losses[-1], \
                variants[-1]
            if not self._finite('guard'):
                warnings.warn(f'non-finite loss at step {self.step}; '
                              f'stopping (the last checkpoint is '
                              f'recoverable)')
                return
            with tracing.span('bhnerf.loop.callbacks'):
                if per_step_fns:
                    tracing.counters.add('host_syncs.replay')
                    for i, loss in enumerate(losses.cpu()):
                        self.step, self.loss = step - chunk + i + 1, loss
                        self.variant = variants[i]
                        for f in per_step_fns:
                            f(self)
                    self.step, self.loss = step, losses[-1]
                for f in chunk_fns:
                    f(self)
            self.save_checkpoint()
            if shutdown.requested:
                self.save_checkpoint(force=True)
                return
            if verbose and (step - self.init_step + 1) // report > \
                    (step - chunk - self.init_step + 1) // report:
                tracing.counters.add('host_syncs.report')
                print(f'iteration {step}: loss {float(self.loss):.6g}',
                      flush=True)


def _mesh_kw(mesh):
    """The scan meta's `mesh` keyword: only for frames split over a mesh,
    so that a meta without one is the reference's (make_scan_step's
    keywords)."""
    return {} if mesh is None else {'mesh': mesh}


def _mesh_of(train_step, raytracing_args):
    """The one mesh of a train step's frames and ray constants, or None;
    different meshes raise ValueError."""
    meshes = {id(m): m for m in
              [a.mesh for a in train_step.args]
              + [getattr(rt, 'mesh', None) for rt in _as_list(raytracing_args)]
              if m is not None}
    if len(meshes) > 1:
        raise ValueError('the frames and ray constants of a run are on '
                         'different meshes')
    return next(iter(meshes.values()), None)


class TrainStep:
    """Composable container of (dtype, args, grad/test fns, scale), one
    entry per loss (reference optimization.py:145-268). scan_meta: one
    dict per loss of the make_scan_step keyword arguments of its loss
    (make_composed_scan_step takes the list); None keeps the step on the
    per-step loop of Optimizer.run."""

    def __init__(self, dtype, args, grad_fn, test_fn, scale,
                 scan_meta=None):
        self.dtype = _as_list(dtype)
        self.args = _as_list(args)
        self.grad_fn = _as_list(grad_fn)
        self.test_fn = _as_list(test_fn)
        self.scale = _as_list(scale)
        self.scan_metas = None if scan_meta is None else _as_list(scan_meta)
        if any(arg.t_units != units.hr for arg in self.args):
            raise ValueError('only hr units supported')
        self.num_losses = len(self.dtype)
        if {len(self.args), len(self.grad_fn), len(self.test_fn),
                len(self.scale)} != {self.num_losses}:
            raise ValueError('input list sizes are not equal')
        if len({a.num_frames for a in self.args}) > 1:
            # frame-batch indices are drawn once per step and applied to
            # every loss
            raise ValueError(
                'composed losses must share the frame count: got '
                f'{[a.num_frames for a in self.args]} frames per loss')

    def __call__(self, state, raytracing_args, indices, update_state=True,
                 variant=None):
        """One step of every loss. raytracing_args: one set of ray
        constants or a list of them (a sub-pixel ray ensemble). A
        gradient step trains on the one variant numbered `variant`
        (required for an ensemble of several); a test step returns the
        mean loss and images over all variants
        (reference optimization.py:157-187)."""
        rt_list = _as_list(raytracing_args)
        if update_state:
            fns = self.grad_fn
            if variant is None:
                if len(rt_list) > 1:
                    raise ValueError(
                        'a gradient step over an ensemble needs `variant`, '
                        'the index of the ray constants to train on')
                variant = 0
            rt_list = [rt_list[variant]]
        else:
            fns = self.test_fn

        total_loss, total_images = 0.0, 0.0
        # a tensor already on the device (a chunk's row) is used as it is
        idx = indices if isinstance(indices, torch.Tensor) \
            else torch.as_tensor(np.asarray(indices))
        for rt in rt_list:
            for i in range(self.num_losses):
                args = self.args[i].device_args
                loss, state, images = fns[i](
                    state, *args, idx.to(args[0].device, torch.int64), rt,
                    self.scale[i])
                # accumulated on the device: no synchronise per step
                total_loss = total_loss + loss / len(rt_list)
                total_images = total_images + images / len(rt_list)
        return total_loss, state, total_images

    @property
    def scan_meta(self):
        """The make_scan_step keyword arguments of a single scannable
        loss; None for a composed or an unscannable step."""
        if self.scan_metas is not None and len(self.scan_metas) == 1:
            return self.scan_metas[0]
        return None

    def __add__(self, other):
        metas = (self.scan_metas + other.scan_metas
                 if self.scan_metas is not None
                 and other.scan_metas is not None else None)
        return TrainStep(self.dtype + other.dtype, self.args + other.args,
                         self.grad_fn + other.grad_fn,
                         self.test_fn + other.test_fn,
                         self.scale + other.scale, scan_meta=metas)

    @classmethod
    @tracing.traced('bhnerf.setup.train_step')
    def image(cls, t_frames, target, predictor, sigma=1.0, offset=0.0,
              scale=1.0, dtype='full', mesh=None, fused=False, tv_scale=0.0,
              tv_fov=None, tv_resolution=32, device='cuda'):
        """Image-plane ('full') or lightcurve ('lc') training step
        (reference optimization.py:189-217). sigma and offset broadcast
        against the target, so a (3,) sigma serves an (nt, 3) polarized
        lightcurve. mesh: frame data-parallelism (each rank renders its
        share of every gradient step's batch; step.make_step_fns).
        fused=True routes the render through the fused CUDA kernels;
        tv_scale > 0 adds a total-variation penalty on the canonical-frame
        volume (step.tv_loss)."""
        target = np.asarray(target)
        sigma = sigma * np.ones_like(target)
        offset = offset * np.ones_like(target)
        args = TemporalBatchedArgs(t_frames, [target, sigma, offset],
                                   mesh=mesh, device=device)
        grad_fn, test_fn = step_lib.make_step_fns(
            predictor, kind='image', dtype=dtype, fused=fused,
            tv_scale=tv_scale, tv_fov=tv_fov, tv_resolution=tv_resolution,
            mesh=mesh)
        meta = dict(predictor=predictor, kind='image', dtype=dtype,
                    fused=fused, tv_scale=tv_scale, tv_fov=tv_fov,
                    tv_resolution=tv_resolution, **_mesh_kw(mesh))
        return cls(dtype, args, grad_fn, test_fn, scale, scan_meta=meta)

    @classmethod
    @tracing.traced('bhnerf.setup.train_step')
    def eht(cls, t_frames, obs, image_fov, image_size, predictor,
            chisqdata=None, dtype='vis', pol='I', scale=1.0, mesh=None,
            fused=False, operator='dense', device='cuda'):
        """EHT measurement training step (reference optimizer.py:444-476,
        optimization.py:219-268). obs: an observation.Observation, or
        anything with chisqdata(t_frames, dtype, image_fov, image_size,
        pol) -> (target, sigma, A) stacked per frame. pol may be a list
        ('vis'/'amp' only), whose operators act on the matching Stokes
        images of polarized ray constants. operator='factored' builds the
        separable operator, npix-fold smaller than the dense DFT matrix
        and equal to it within float32 round-off. The targets, sigmas and
        operators live on `device` in float32 whatever the predictor's
        compute dtype, whole on every rank of a `mesh` (frame
        data-parallelism, as in TrainStep.image)."""
        if chisqdata is not None:
            dtype = getattr(chisqdata, 'dtype', dtype)
        # operator= only when it is not the default: a duck-typed
        # observation need implement only chisqdata(t, dtype, fov, size,
        # pol)
        op_kw = {} if operator == 'dense' else {'operator': operator}
        target, sigma, A = obs.chisqdata(t_frames, dtype, image_fov,
                                         image_size, pol=pol, **op_kw)
        target, sigma, A = step_lib.to_real_measurements(dtype, target,
                                                         sigma, A)
        args = TemporalBatchedArgs(t_frames, [target, sigma, A], mesh=mesh,
                                   device=device)
        grad_fn, test_fn = step_lib.make_step_fns(predictor, kind='eht',
                                                  dtype=dtype, fused=fused,
                                                  mesh=mesh)
        meta = dict(predictor=predictor, kind='eht', dtype=dtype,
                    fused=fused, **_mesh_kw(mesh))
        return cls(dtype, args, grad_fn, test_fn, scale, scan_meta=meta)

    @property
    def t_units(self):
        return self.args[0].t_units


class TemporalBatchedArgs:
    """Frame-indexed args resident on one device
    (reference optimization.py:274-302, :484-566). Under a mesh every rank
    holds the whole frame tensors, and a gradient step renders the rank's
    share of its batch (step.make_step_fns)."""

    def __init__(self, t_frames, args=(), mesh=None, device='cuda'):
        self.t_frames = t_frames
        args = list(args) if isinstance(args, (list, tuple)) else [args]
        self.num_frames = len(t_frames)
        if not all(self.num_frames == np.shape(arg)[0] for arg in args):
            raise ValueError('every arg needs one row per frame')
        t_vals, self._t_unit = units.strip_time(t_frames, units.hr)
        args.append(np.asarray(t_vals, np.float32))
        self.args = args
        self.mesh = mesh
        self.device = device
        self._device_args = None
        ndata = 1 if mesh is None else mesh.shape.get('data', 1)
        if self.num_frames % ndata:
            # the reference then replicates its frame tensors
            # (optimizer.py:516-531); the port keeps them whole on every
            # rank in any case and splits each batch
            warnings.warn(
                f'num_frames={self.num_frames} does not divide the '
                f"'data' mesh axis ({ndata}); frame tensors fall back to "
                f'full replication (every rank holds all frames)')

    @property
    def device_args(self):
        """Full frame tensors on the device (uploaded once, lazily); the
        step selects its frame batch from them by index."""
        if self._device_args is None:
            self._device_args = [
                torch.as_tensor(np.asarray(a, np.float32)).to(self.device)
                for a in self.args]
        return self._device_args

    def sample(self, batchsize, generator=None):
        """Frame indices drawn uniformly without replacement from
        `generator`."""
        return torch.randperm(self.num_frames, generator=generator)[
            :batchsize]

    @property
    def t_units(self):
        return self._t_unit

    @property
    def t_start_obs(self):
        return self.t_frames[0]


class LogFn:
    """Periodic logging callback wrapper (reference optimization.py:349-357)."""

    def __init__(self, log_fn, log_period=1):
        self.log_period = log_period
        self.log_fn = log_fn

    def __call__(self, optimizer):
        if self.log_period > 0:
            if (optimizer.step == 1
                    or optimizer.step % self.log_period == 0):
                self.log_fn(optimizer)
