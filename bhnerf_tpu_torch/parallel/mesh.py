"""The ('data', 'ray') mesh over torch.distributed ranks, and its
collectives.

PyTorch counterpart of `bhnerf_tpu/parallel/mesh.py`. JAX runs one
program over every device of a `jax.sharding.Mesh`; the port runs one
process per rank, as `torchrun` starts them. Each rank holds the
replicated parameters and its own block of the sharded tensors:

* 'data' holds movie frames: every rank draws the same frame batch and
  takes its contiguous share of it by its 'data' coordinate (frame
  data-parallelism, the original project's pmap strategy);
* 'ray' holds samples: in the sample-parallel compact layout
  (`train.step.compact_raytracing_args(mesh=...)`) each rank owns one
  block of the in-domain samples, renders it and reduces it to a partial
  image; one all-reduce over the 'ray' group sums the partials
  (`sum_partials`).

The mapping from the reference:

* `Mesh` over devices -> a `Mesh` over ranks: its shape, this rank's
  coordinates and one process group per axis (`dist.new_group`);
* `shard_map` + `psum` of partial images -> `sum_partials`, an autograd
  Function that sums forward and is the identity backward;
* the transpose's psum of the parameters' cotangents ->
  `all_reduce_gradients`, one summed all-reduce before Adam;
* `P('data')` frame batches -> `shard_frames` / `batch_share`;
* `replicated` placement -> `replicate`, a broadcast from rank 0.

Only `all_reduce` and `broadcast` are used (and `barrier` where a
checkpoint is written). PyTorch's gloo backend takes CUDA tensors for
those and for nothing else, and NCCL refuses two ranks on one device; so
the same code runs under NCCL (one rank a card, the production case) and
under gloo (the CPU, and several ranks sharing one card). The reference's
`frame_sharding`, `replicated` and `ray_sharding_spec` return
`NamedSharding`s, a type the port has no counterpart of; they are not
ported.

Every collective is counted in its mesh's `census` (a `tracing.Census`):
how many of each kind over which axes, and the largest element count of
each, under the key '<kind> over <axes joined by +>'.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from bhnerf_tpu_torch.tracing import Census

AXES = ('data', 'ray')
# the variables torchrun sets for every rank
_CLUSTER_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


def _census_key(kind, axes):
    return f'{kind} over {"+".join(axes)}'


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (data, ray) grid of ranks, row-major: rank = data * ray_size +
    ray. `shape` maps each axis name to its size, as the reference's
    `Mesh.shape` does; `groups` holds, for each axis of size > 1, the
    process group of the ranks that differ from this one along that axis
    only (empty for a mesh of one process, or one built without
    torch.distributed, which can then run no collective). `device` is
    where this rank's tensors live."""

    shape: dict
    rank: int = 0
    device: torch.device = torch.device('cpu')
    groups: dict = dataclasses.field(default_factory=dict)
    census: Census = dataclasses.field(default_factory=Census)

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))

    @property
    def coords(self):
        """This rank's coordinate along each axis."""
        return dict(zip(self.axis_names, np.unravel_index(
            self.rank, tuple(self.shape.values()))))

    def _group(self, axes):
        """The process group spanning `axes` (names of axes of size > 1):
        the axis's own group, or every rank for all of them."""
        if set(axes) == {a for a, n in self.shape.items() if n > 1}:
            return None if len(axes) > 1 else self.groups[axes[0]]
        if len(axes) == 1:
            return self.groups[axes[0]]
        raise ValueError(f'no process group spans {axes} of {self.shape}')

    def all_reduce(self, tensor, axes, kind, op='sum'):
        """In-place all-reduce of `tensor` over the ranks that differ
        along `axes`; axes of size 1 take no part, and none left is a
        no-op. Returns `tensor`."""
        axes = tuple(a for a in axes if self.shape[a] > 1)
        if not axes:
            return tensor
        self.census.add(_census_key(kind, axes), tensor.numel())
        dist.all_reduce(tensor, op={'sum': dist.ReduceOp.SUM,
                                    'max': dist.ReduceOp.MAX}[op],
                        group=self._group(axes))
        return tensor

    def broadcast(self, tensor, kind):
        """In-place broadcast of `tensor` from rank 0 to every rank."""
        if self.size > 1:
            self.census.add(_census_key(kind, self.axis_names),
                            tensor.numel())
            dist.broadcast(tensor, src=0)
        return tensor


def _resolve_device(device):
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_rank():
    """This process's rank (0 without torch.distributed)."""
    return dist.get_rank() if dist.is_initialized() else 0


def create_mesh(shape=None, axis_names=AXES, device='cuda'):
    """A (data, ray) mesh over every rank of torch.distributed (one
    process without it). shape=None puts every rank on 'data' (frame
    data-parallelism, the reference's strategy); pass e.g. (2, 2) to also
    shard samples. Every rank must call it, in the same order as its
    other process-group calls: it creates one group per row and column.
    `device` is this rank's device ('cuda' is the current CUDA device,
    which initialize_distributed sets)."""
    n = world_size()
    if shape is None:
        shape = (n, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f'mesh shape {shape} for axes {axis_names}')
    if int(np.prod(shape)) != n:
        raise ValueError(f'mesh shape {shape} != #ranks {n}')
    mesh = Mesh(dict(zip(axis_names, shape)), process_rank(),
                _resolve_device(device))
    grid = np.arange(n).reshape(shape)
    for ax, size in enumerate(shape):
        if size == 1:
            continue
        # every rank creates every group, in the same order
        lines = np.moveaxis(grid, ax, -1).reshape(-1, size)
        for ranks in lines:
            group = dist.new_group([int(r) for r in ranks])
            if mesh.rank in ranks:
                mesh.groups[axis_names[ax]] = group
    return mesh


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None, device=None):
    """Start torch.distributed for a multi-process run.

    Safe to call at the top of a fitting script: returns False for a
    single process with no cluster environment, True once the process
    group is up (or already was). Under `torchrun` the rank, world size
    and coordinator come from RANK, WORLD_SIZE and MASTER_ADDR /
    MASTER_PORT; an explicit `coordinator_address` ('host:port') with
    `num_processes` and `process_id` replaces them. An environment that
    sets some of those variables and not the others raises RuntimeError
    (reference mesh.py:80-147 refuses to fall back to a single process on
    a half-configured cluster).

    `device` is this rank's device, by default cuda:<LOCAL_RANK> (the
    rank itself without LOCAL_RANK); a CUDA device that does not exist
    raises, and the index is never wrapped round. `backend` defaults to
    'nccl' for a CUDA device and 'gloo' for the CPU; it is never swapped
    for another when its initialisation fails. Several ranks on one card
    need backend='gloo': NCCL refuses two ranks on one device.
    """
    if dist.is_initialized():
        return True
    env = {k: os.environ.get(k) for k in _CLUSTER_ENV}
    if coordinator_address is None:
        present = [k for k, v in env.items() if v]
        if not present:
            return False
        missing = [k for k, v in env.items() if not v]
        if missing:
            raise RuntimeError(
                f'the cluster environment is half set: {present} set, '
                f'{missing} not; set all of {list(_CLUSTER_ENV)} (torchrun '
                f'does) or none of them')
        coordinator_address = f'{env["MASTER_ADDR"]}:{env["MASTER_PORT"]}'
    if num_processes is None:
        num_processes = _env_int('WORLD_SIZE')
    if process_id is None:
        process_id = _env_int('RANK')
    local_rank = int(os.environ.get('LOCAL_RANK', process_id))
    device = torch.device('cuda', local_rank) if device is None \
        else torch.device(device)
    if device.type == 'cuda':
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        count = torch.cuda.device_count()
        if index >= count:
            raise RuntimeError(f'rank {process_id} is to run on cuda:{index}, '
                               f'but this machine has {count} CUDA devices')
        torch.cuda.set_device(index)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError(f"backend 'nccl' needs a CUDA device, not {device}")
    dist.init_process_group(backend, init_method=f'tcp://{coordinator_address}',
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def _env_int(name):
    value = os.environ.get(name)
    if value is None:
        raise RuntimeError(f'{name} is not set: pass it to '
                           f'initialize_distributed or run under torchrun')
    return int(value)


def hybrid_shape(num_ranks, ranks_per_node, ici_shape=None):
    """The (data, ray) shape of create_hybrid_mesh: `ici_shape` is the
    per-node factorisation (None: every rank of a node on 'data'), and the
    node axis folds into 'data'."""
    if num_ranks % ranks_per_node:
        raise ValueError(f'{num_ranks} ranks do not fill nodes of '
                         f'{ranks_per_node}')
    nodes = num_ranks // ranks_per_node
    if ici_shape is None:
        ici_shape = (ranks_per_node, 1)
    if int(np.prod(ici_shape)) != ranks_per_node:
        raise ValueError(f'ici_shape {tuple(ici_shape)} != ranks/node '
                         f'{ranks_per_node}')
    return (nodes * int(ici_shape[0]), *(int(s) for s in ici_shape[1:]))


def create_hybrid_mesh(ici_shape=None, axis_names=AXES, device='cuda'):
    """(data, ray) mesh over ranks grouped by node (reference
    mesh.py:156-184, with the node in the slice's place). `ici_shape` is
    the per-node (data, ray) factorisation; None puts every rank of a node
    on 'data'. The node count comes from LOCAL_WORLD_SIZE (ranks per node,
    as torchrun sets it). torchrun numbers ranks node by node, and the
    mesh is row-major, so each 'ray' row (its image all-reduce every
    step) stays inside a node, on NVLink, while 'data' (one gradient
    all-reduce a step) crosses nodes. One node: create_mesh(ici_shape)."""
    n = world_size()
    per_node = int(os.environ.get('LOCAL_WORLD_SIZE', n))
    if per_node == n:
        return create_mesh(ici_shape, axis_names, device)
    return create_mesh(hybrid_shape(n, per_node, ici_shape), axis_names,
                       device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _share(n, mesh, what):
    """(start, stop) of this rank's contiguous share of n rows over the
    'data' axis."""
    ndata = mesh.shape.get('data', 1)
    if n % ndata:
        raise ValueError(f'{what} of {n} does not divide the data axis '
                         f'({ndata})')
    d = int(mesh.coords.get('data', 0))
    return d * n // ndata, (d + 1) * n // ndata


def batch_share(indices, mesh):
    """This rank's contiguous share of a frame batch by its 'data'
    coordinate (every rank draws the same batch). Raises ValueError when
    the 'data' size does not divide the batch."""
    start, stop = _share(len(indices), mesh, 'a frame batch')
    return indices[start:stop]


def shard_frames(tree, mesh):
    """This rank's block of the leading (frame) axis of every array or
    tensor in `tree` (nested dicts, lists and tuples), by its 'data'
    coordinate (the reference places P('data') shards). Raises ValueError
    when the 'data' size does not divide a leading axis."""
    def block(x):
        start, stop = _share(len(x), mesh, 'a leading axis')
        return x[start:stop]
    return _tree_map(block, tree)


def replicate(tree, mesh):
    """Every tensor of `tree` with rank 0's values, on every rank: a
    broadcast from rank 0 (the reference places the tree replicated).
    Tensors are overwritten in place; arrays become tensors on the mesh's
    device."""
    def one(x):
        t = x if isinstance(x, torch.Tensor) else \
            torch.as_tensor(np.asarray(x)).to(mesh.device)
        with torch.no_grad():
            mesh.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t,
                           'replicate')
        return t
    return _tree_map(one, tree)


def make_global_frames(tree, mesh, num_frames=None):
    """Multi-process form of shard_frames (reference mesh.py:187-208):
    each rank passes its own span of the frame axis, the frames of its
    'data' coordinate, and keeps it, as tensors on the mesh's device. An
    all-reduce over 'data' checks that the spans are equal (P('data')
    shards are) and, given `num_frames`, that they add up to it. With one
    'data' rank the span is the whole axis, as shard_frames gives it."""
    spans = {len(x) for x in _leaves(tree)}
    if len(spans) != 1:
        raise ValueError(f'frame spans of different lengths {sorted(spans)}')
    span = spans.pop()
    ndata = mesh.shape.get('data', 1)
    check = torch.tensor([span, -span], dtype=torch.int64,
                         device=collective_device(mesh))
    mesh.all_reduce(check, ('data',), 'frames', op='max')
    if int(check[0]) != -int(check[1]):
        raise ValueError(f'frame spans differ across ranks: '
                         f'{-int(check[1])}..{int(check[0])} (this rank '
                         f'{span})')
    if num_frames is not None and span * ndata != num_frames:
        raise ValueError(f'{ndata} spans of {span} frames are not the '
                         f'{num_frames} frames')
    return _tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(mesh.device)
                     if not isinstance(x, torch.Tensor) else
                     x.to(mesh.device), tree)


def collective_device(mesh=None):
    """Where a small bookkeeping tensor (a seed, a step) goes for a
    collective: the CPU under gloo, this rank's card under NCCL."""
    if dist.is_initialized() and dist.get_backend() == 'nccl':
        return mesh.device if mesh is not None else torch.device(
            'cuda', torch.cuda.current_device())
    return torch.device('cpu')


def agree(value, mesh=None, what='value'):
    """The (min, max) of an integer over every rank, in one all-reduce
    (MAX of value and -value); (value, value) for one process."""
    if world_size() == 1:
        return value, value
    t = torch.tensor([value, -value], dtype=torch.int64,
                     device=collective_device(mesh))
    if mesh is not None:
        mesh.all_reduce(t, mesh.axis_names, what, op='max')
    else:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return -int(t[1]), int(t[0])


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, kind, *parts):
        flat = torch.cat([p.reshape(-1) for p in parts])
        mesh.all_reduce(flat, (axis,), kind)
        return tuple(x.reshape(p.shape) for x, p in zip(
            torch.split(flat, [p.numel() for p in parts]), parts))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *grads)


def sum_partials(mesh, axis, *parts, kind='image'):
    """The sum over the `axis` group of each rank's partial results (the
    partial images, and the lightcurve beside them, of its sample block),
    in one all-reduce of their concatenation, counted in the census as
    `kind`: the reference's psum at the end of its shard_map
    (train/step.py:623-677). Rule of the
    collectives: it sums forward and is the identity backward. Every rank
    computes the same loss from the same summed image, so the cotangent of
    each rank's partial is the image's cotangent as it stands.
    (torch.distributed.nn.functional.all_reduce also sums the cotangent,
    which would scale every gradient by the axis size.) Returns a tuple,
    one tensor per part."""
    return _SumPartials.apply(mesh, axis, kind, *parts)


def all_reduce_gradients(params, mesh, axes):
    """Sum the gradients of every parameter of `params` (an nn.Module)
    over the ranks that differ along `axes`, in one all-reduce of their
    concatenation, before Adam. Rule of the collectives: a sum, not a
    mean. The chi-square losses are global sums, so each rank's gradients
    are partials of its samples and its frames, and their sum is the
    one-process gradient of the same global batch (DDP would average). A
    parameter without a gradient takes part as zeros."""
    ps = list(params.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in ps]
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce(flat, axes, 'grad')
    for p, g in zip(ps, torch.split(flat, [p.numel() for p in ps])):
        p.grad = g.view_as(p)


def broadcast_parameters(params, mesh):
    """Rank 0's values of every parameter of `params` (an nn.Module) on
    every rank: one broadcast of their concatenation."""
    ps = list(params.parameters())
    with torch.no_grad():
        flat = torch.cat([p.reshape(-1) for p in ps])
        mesh.broadcast(flat, 'params')
        for p, x in zip(ps, torch.split(flat, [p.numel() for p in ps])):
            p.copy_(x.view_as(p))


def check_same_seed(seed, mesh):
    """Every rank must draw the same frame batches and variants, so every
    rank's generator must start from the same seed: one all-reduce (MAX of
    the seed and of its negation) tells, and a difference raises
    RuntimeError."""
    lo, hi = agree(int(seed), mesh, 'seed')
    if lo != hi:
        raise RuntimeError(f'the ranks were given different seeds ({lo}..'
                           f'{hi}; this rank {seed}): every rank must draw '
                           f'the same batches')


__all__ = ['AXES', 'Census', 'Mesh', 'all_reduce_gradients', 'agree',
           'batch_share', 'broadcast_parameters', 'check_same_seed', 'collective_device',
           'create_hybrid_mesh', 'create_mesh', 'hybrid_shape',
           'initialize_distributed', 'make_global_frames', 'process_rank',
           'replicate', 'shard_frames', 'sum_partials', 'world_size']
