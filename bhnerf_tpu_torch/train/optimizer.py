"""Training orchestration: the Optimizer loop, TrainStep, frame batching.

PyTorch counterpart of the main-path subset of
`bhnerf_tpu/train/optimizer.py`: `Optimizer` with its per-step `run` loop
and non-finite guard (:90-200), `TrainStep.image` (:417-441),
`TemporalBatchedArgs` (:483-575) and `LogFn` (:577). Frame batches are
drawn from the Optimizer's explicit `torch.Generator`; the full frame
tensors live on the training device and each step selects its batch
there, so a step uploads only its indices.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from bhnerf_tpu_torch import units
from bhnerf_tpu_torch.train import state as state_lib
from bhnerf_tpu_torch.train import step as step_lib


class Optimizer:
    """Gradient-descent loop (reference optimization.py:68-143)."""

    def __init__(self, hparams, predictor, raytracing_args, device='cpu'):
        self.step = 0
        self.init_step = 0
        self.num_iters = hparams['num_iters']
        self.loss = np.inf
        self.seed = hparams.get('seed', 1)
        self.predictor = predictor
        # one explicit generator draws the initial weights and then every
        # frame batch
        self.generator = torch.Generator().manual_seed(self.seed)
        if hparams.get('lr_inject') is not None:
            raise NotImplementedError('lr_inject is not ported yet')
        params = predictor.init_params(generator=self.generator,
                                       device=device)
        tx = state_lib.make_optimizer(
            num_iters=self.num_iters,
            lr_init=hparams.get('lr_init', 1e-4),
            lr_final=hparams.get('lr_final', 1e-6))
        self.state = state_lib.TrainState.create(params, tx)

    def log(self):
        for log_fn in self.log_fns:
            log_fn(self)

    def run(self, batchsize, train_step, raytracing_args, log_fns=(),
            verbose=True, nan_check_period=1000):
        """Training loop (reference optimization.py:123-139) with a
        periodic non-finite-loss guard (checking every step would force a
        host sync per step)."""
        self.init_step = self.state.step + 1
        self.final_step = self.init_step + self.num_iters
        self.log_fns = list(log_fns)
        self.train_step = train_step
        self.raytracing_args = raytracing_args
        report = max(1, self.num_iters // 10)

        for self.step in range(self.init_step, self.final_step):
            batch = train_step.args.sample(batchsize, self.generator)
            self.loss, self.state, images = train_step(
                self.state, raytracing_args, indices=batch)
            if (nan_check_period and self.step % nan_check_period == 0
                    and not torch.isfinite(self.loss).all()):
                warnings.warn(f'non-finite loss at step {self.step}; '
                              f'stopping')
                return
            self.log()
            if verbose and (self.step - self.init_step + 1) % report == 0:
                print(f'iteration {self.step}: loss {float(self.loss):.6g}',
                      flush=True)


class TrainStep:
    """One image loss: its frame args, grad/test fns and scale
    (reference optimization.py:145-268, without composition)."""

    def __init__(self, args, grad_fn, test_fn, scale):
        if args.t_units != units.hr:
            raise ValueError('only hr units supported')
        self.args = args
        self.grad_fn = grad_fn
        self.test_fn = test_fn
        self.scale = scale

    def __call__(self, state, raytracing_args, indices, update_state=True):
        fn = self.grad_fn if update_state else self.test_fn
        args = self.args.device_args
        idx = torch.as_tensor(np.asarray(indices), dtype=torch.int64,
                              device=args[0].device)
        return fn(state, *args, idx, raytracing_args, self.scale)

    @classmethod
    def image(cls, t_frames, target, predictor, sigma=1.0, offset=0.0,
              scale=1.0, dtype='full', fused=False, device='cpu'):
        """Image-plane training step (reference optimization.py:189-217).
        fused=True routes the render through the fused CUDA kernels."""
        target = np.asarray(target)
        sigma = sigma * np.ones_like(target)
        offset = offset * np.ones_like(target)
        args = TemporalBatchedArgs(t_frames, [target, sigma, offset],
                                   device=device)
        grad_fn, test_fn = step_lib.make_step_fns(predictor, dtype=dtype,
                                                  fused=fused)
        return cls(args, grad_fn, test_fn, scale)


class TemporalBatchedArgs:
    """Frame-indexed args resident on one device
    (reference optimization.py:274-302)."""

    def __init__(self, t_frames, args=(), device='cpu'):
        self.t_frames = t_frames
        args = list(args) if isinstance(args, (list, tuple)) else [args]
        self.num_frames = len(t_frames)
        if not all(self.num_frames == np.shape(arg)[0] for arg in args):
            raise ValueError('every arg needs one row per frame')
        t_vals, self._t_unit = units.strip_time(t_frames, units.hr)
        args.append(np.asarray(t_vals, np.float32))
        self.args = args
        self.device = device
        self._device_args = None

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
