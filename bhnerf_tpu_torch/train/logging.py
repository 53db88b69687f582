"""Tensorboard logging, profiling and step timing.

PyTorch counterpart of `bhnerf_tpu/train/logging.py`: `SummaryWriter` on
tensorboardX with the log-closure factories `recovery_3d` and
`plot_lc_datafit` (reference optimization.py:304-347), `StepTimer`, and
`profile_trace` as a torch.profiler trace in place of jax.profiler.
`MemoryWriter` keeps what a fit logs in memory, with neither tensorboardX
nor matplotlib, for runs on machines that lack them and for tests.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from bhnerf_tpu_torch import tracing, utils
from bhnerf_tpu_torch.models.fields import sample_3d_grid
from bhnerf_tpu_torch.train.optimizer import _as_list, total_movie_loss

try:
    import tensorboardX
    _HAS_TBX = True
except ImportError:
    _HAS_TBX = False


class _LogClosures:
    """The log closures of a fit, over a writer's add_scalar and its two
    hooks: `add_volume` (an emission volume, also called by a fit script
    for the true one) and
    `_add_lightcurves` (a lightcurve fit against its target)."""

    def recovery_3d(self, fov, vis_res=64, emission_true=None):
        """A LogFn target that samples the field on a vis_res^3 grid over
        `fov` (or on the grid of `emission_true`, a utils.Grid3D, and then
        also logs the mse and psnr against it)."""
        if emission_true is not None:
            vis_coords = np.stack(np.meshgrid(
                *(emission_true.coord_1d(a) for a in range(3)),
                indexing='ij'))
        else:
            grid_1d = np.linspace(-fov / 2, fov / 2, vis_res)
            vis_coords = np.stack(np.meshgrid(grid_1d, grid_1d, grid_1d,
                                              indexing='ij'))

        def log_fn(opt):
            emission_grid = sample_3d_grid(opt.predictor, opt.params,
                                           coords=vis_coords)
            self.add_volume('emission/estimate', emission_grid, opt.step)
            if emission_true is not None:
                true = emission_true.data
                self.add_scalar('emission/mse',
                                utils.mse(true, emission_grid),
                                global_step=opt.step)
                self.add_scalar('emission/psnr',
                                utils.psnr(true, emission_grid),
                                global_step=opt.step)

        return log_fn

    def plot_lc_datafit(self, opt, name, train_step, target, stokes,
                        t_frames=None, batchsize=20):
        """Log the lightcurve of the whole movie of `train_step` against
        `target`, and log10 of its mean test loss as datafit/<name>. The
        movie is rendered through one variant of the ensemble: the one the
        optimizer's last step trained on (the reference draws one at
        random)."""
        rt = _as_list(opt.raytracing_args)[opt.variant]
        loss, movie = total_movie_loss(batchsize, opt.state, train_step, rt,
                                       return_frames=True)
        lc_est = movie.sum(axis=(-1, -2))
        self._add_lightcurves(name, target, lc_est, stokes, t_frames,
                              opt.step)
        self.add_scalar(f'datafit/{name}', float(np.log10(np.mean(loss))),
                        global_step=opt.step)


class SummaryWriter(_LogClosures,
                    tensorboardX.SummaryWriter if _HAS_TBX else object):
    """tensorboardX writer with the fit's log-closure factories (reference
    logging.py:20-29). Without tensorboardX it raises ImportError when
    made, not hours into a fit."""

    def __init__(self, *args, **kwargs):
        if not _HAS_TBX:
            raise ImportError(
                'tensorboardX is required for SummaryWriter (failing fast '
                'here beats an AttributeError hours into training)')
        super().__init__(*args, **kwargs)

    def add_volume(self, tag, volume, step):
        self.add_images(tag, utils.intensity_to_nchw(volume),
                        dataformats='NCWH', global_step=step)

    def _add_lightcurves(self, name, target, lc_est, stokes, t_frames,
                         step):
        import matplotlib.pyplot as plt
        from bhnerf_tpu_torch import visualization
        axes = visualization.plot_stokes_lc(target, stokes, t_frames,
                                            label='True')
        axes = visualization.plot_stokes_lc(lc_est, stokes, t_frames,
                                            axes=axes, fmt='x', color='r',
                                            label='Estimate')
        for ax in np.atleast_1d(axes):
            ax.legend()
        self.add_figure(f'lightcurve/{name}', plt.gcf(), global_step=step)


class MemoryWriter(_LogClosures):
    """A writer that keeps what a fit logs in memory: `scalars` maps a tag
    to its [(step, value)], `volumes` and `lightcurves` map a tag to its
    [(step, array)]. Needs neither tensorboardX nor matplotlib."""

    def __init__(self, logdir=None):
        self.logdir = logdir
        self.scalars, self.volumes, self.lightcurves = {}, {}, {}

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.setdefault(tag, []).append((global_step, float(value)))

    def add_volume(self, tag, volume, step):
        self.volumes.setdefault(tag, []).append((step, np.asarray(volume)))

    def _add_lightcurves(self, name, target, lc_est, stokes, t_frames,
                         step):
        self.lightcurves.setdefault(f'lightcurve/{name}', []).append(
            (step, np.asarray(lc_est)))

    def close(self):
        pass


@contextlib.contextmanager
def profile_trace(logdir):
    """torch.profiler trace of the host and, where there is one, the card,
    written under `logdir` as a chrome trace when the scope ends (the
    reference's jax.profiler trace), with the program's spans
    (`tracing`) on for the scope: they show in the trace as
    `user_annotation`s beside the kernels. Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on = tracing.enable()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(str(logdir))) \
                as prof:
            yield prof
    finally:
        if not was_on:
            tracing.disable()


class StepTimer:
    """Steps/s between two calls, usable as a LogFn target (reference
    logging.py:108-126). A step read at a chunk's end counts the whole
    chunk."""

    def __init__(self):
        self.last_t = None
        self.last_step = None
        self.steps_per_sec = float('nan')

    def __call__(self, opt):
        now = time.perf_counter()
        if opt.step == self.last_step:
            return  # a second call at the same step keeps the clock
        if self.last_t is not None:
            self.steps_per_sec = (opt.step - self.last_step) / (
                now - self.last_t)
        self.last_t = now
        self.last_step = opt.step
