"""Reference-API facade for the training-orchestration layer.

PyTorch counterpart of `bhnerf_tpu/optimization.py` (the reference's
`bhnerf.optimization`): the implementations live in
`bhnerf_tpu_torch.train`.
"""
import numpy as np
import torch

from bhnerf_tpu_torch.parallel.mesh import shard_frames
from bhnerf_tpu_torch.train.logging import (SummaryWriter, StepTimer,
                                            profile_trace)
from bhnerf_tpu_torch.train.optimizer import (LogFn, Optimizer,
                                              TemporalBatchedArgs, TrainStep,
                                              total_movie_loss)


def _tree_map(fn, xs):
    if isinstance(xs, dict):
        return {k: _tree_map(fn, v) for k, v in xs.items()}
    if isinstance(xs, (list, tuple)):
        return type(xs)(_tree_map(fn, v) for v in xs)
    return fn(xs)


def shard(xs, mesh=None):
    """Reference-signature shard (optimization.py:360-362): the leading
    axis of every array in `xs` (a tensor, an array or nested dicts,
    lists and tuples of them) reshaped to (device count, -1, ...), with
    the count of CUDA devices (1 without one). With a mesh
    (parallel.mesh.Mesh): this rank's block of the leading axis by its
    'data' coordinate (parallel.mesh.shard_frames; reference
    optimization.py:13-18)."""
    if mesh is not None:
        return shard_frames(xs, mesh)
    n = max(torch.cuda.device_count(), 1)

    def split(x):
        if isinstance(x, torch.Tensor):
            return x.reshape(n, -1, *x.shape[1:])
        x = np.asarray(x)
        return x.reshape((n, -1) + x.shape[1:])

    return _tree_map(split, xs)
