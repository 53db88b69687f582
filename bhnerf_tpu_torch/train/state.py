"""Training state, the Adam + polynomial learning-rate schedule, and
checkpoints.

PyTorch counterpart of `bhnerf_tpu/train/state.py`: Adam whose learning
rate follows optax.polynomial_schedule(lr_init, lr_final, 1, num_iters),
a linear decay counted from update 0, optionally with a separate
constant learning rate for the learnable injection offset (:30-83); and
checkpoints in the reference's `checkpoint_<step>` directory layout
(:109-215), written with torch.save instead of orbax: each directory
holds one file of {'step', 'params' (state_dict), 'opt_state' (Adam's
state_dict)} that loads under torch.load(weights_only=True). Single
process: the reference's multi-host step-agreement check waits for the
multi-GPU port.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
from pathlib import Path

import torch
import torch.distributed as dist

from bhnerf_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class AdamSchedule:
    """What make_optimizer returns: Adam (b1 0.9, b2 0.999, eps 1e-8, as
    optax.adam) with a linear learning-rate decay. With lr_inject the
    `t_injection` parameter gets its own Adam at that constant rate and
    every other parameter the scheduled one: two parameter groups, which
    is optax's chain of two masked Adams (reference state.py:69-82)."""

    num_iters: int = 5000
    lr_init: float = 1e-4
    lr_final: float = 1e-6
    lr_inject: float | None = None

    def lr(self, count):
        """optax.polynomial_schedule(lr_init, lr_final, power=1,
        transition_steps=num_iters) at update `count` (0-based)."""
        frac = 1.0 - min(count, self.num_iters) / self.num_iters
        return (self.lr_init - self.lr_final) * frac + self.lr_final

    def build(self, params):
        """torch.optim.Adam over the parameters of `params` (nn.Module).
        Groups that follow the schedule carry scheduled=True."""
        named = list(params.named_parameters())
        if not self.lr_inject:
            groups = [dict(params=[p for _, p in named], scheduled=True)]
        else:
            is_inject = lambda name: name.split('.')[-1] == 't_injection'
            groups = [dict(params=[p for n, p in named if not is_inject(n)],
                           scheduled=True),
                      dict(params=[p for n, p in named if is_inject(n)],
                           lr=self.lr_inject, scheduled=False)]
        return torch.optim.Adam(groups, lr=self.lr(0), betas=(0.9, 0.999),
                                eps=1e-8)


def make_optimizer(num_iters=5000, lr_init=1e-4, lr_final=1e-6,
                   lr_inject=None):
    """Adam + polynomial schedule, with an optional constant learning
    rate for the injection offset (reference network.py:171-180)."""
    return AdamSchedule(num_iters, lr_init, lr_final, lr_inject)


class TrainState:
    """Parameters, their Adam state and the update count."""

    def __init__(self, params, tx: AdamSchedule):
        self.params = params
        self.tx = tx
        self.opt = tx.build(params)
        self.step = 0

    @classmethod
    def create(cls, params, tx):
        return cls(params, tx)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def apply_gradients(self):
        """One Adam update with the gradients accumulated in .grad."""
        for group in self.opt.param_groups:
            if group['scheduled']:
                group['lr'] = self.tx.lr(self.step)
        self.opt.step()
        self.step += 1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
_CKPT_RE = re.compile(r'^checkpoint_(\d+)$')
_CKPT_FILE = 'state.pt'


def _checkpoint_steps(checkpoint_dir):
    return sorted(int(m.group(1)) for p in Path(checkpoint_dir).iterdir()
                  if (m := _CKPT_RE.match(p.name)))


def latest_checkpoint_step(checkpoint_dir):
    """The largest step with a `checkpoint_<step>` directory, or None."""
    if not Path(checkpoint_dir).is_dir():
        return None
    steps = _checkpoint_steps(checkpoint_dir)
    return steps[-1] if steps else None


def save_checkpoint(checkpoint_dir, state: TrainState, step, keep=5):
    """Save params, Adam state and step under checkpoint_<step>, then prune
    all but the newest `keep` checkpoints (keep <= 0 keeps all;
    reference state.py:119-151). The directory is written under a
    temporary name and renamed, so a run killed mid-save leaves no
    partial checkpoint.

    Under torch.distributed every rank calls it and rank 0 alone writes
    and prunes (the parameters and Adam state are the same on every
    rank); the others wait for it at a barrier, so that a restore that
    follows sees the new checkpoint. checkpoint_dir must be on a
    filesystem that every rank sees (restore_checkpoint checks)."""
    if mesh_lib.process_rank() == 0:
        _write_checkpoint(checkpoint_dir, state, step, keep)
    if mesh_lib.world_size() > 1:
        dist.barrier()


def _write_checkpoint(checkpoint_dir, state, step, keep):
    checkpoint_dir = Path(checkpoint_dir).absolute()
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    path = checkpoint_dir / f'checkpoint_{int(step)}'
    tmp = checkpoint_dir / f'.checkpoint_{int(step)}.tmp'
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save({'step': int(state.step),
                'params': state.params.state_dict(),
                'opt_state': state.opt.state_dict()}, tmp / _CKPT_FILE)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if keep > 0:
        for old in _checkpoint_steps(checkpoint_dir)[:-keep]:
            shutil.rmtree(checkpoint_dir / f'checkpoint_{old}',
                          ignore_errors=True)


def _load(checkpoint_dir, step):
    return torch.load(Path(checkpoint_dir) / f'checkpoint_{step}' / _CKPT_FILE,
                      map_location='cpu', weights_only=True)


def _assert_step_agreement(step):
    """Every rank must see the same latest checkpoint step (reference
    state.py:160-179): rank 0 alone writes, so checkpoint_dir must be
    shared by every rank; a rank-local directory would resume the ranks
    at different steps and their collectives would hang. One all-reduce
    (MAX of the step and of its negation) tells; a difference raises
    RuntimeError."""
    local = -1 if step is None else int(step)
    lo, hi = mesh_lib.agree(local, what='step')
    if lo != hi:
        raise RuntimeError(
            f'checkpoint step disagrees across ranks: they see {lo}..{hi} '
            f'(rank {mesh_lib.process_rank()} sees {local}; -1 is none). '
            f'checkpoint_dir must live on a filesystem shared by every rank '
            f'(rank 0 is the only writer); a rank-local path desyncs the '
            f'resume and would hang the collectives.')


def restore_checkpoint(checkpoint_dir, state: TrainState):
    """Load the latest checkpoint into `state` (params, Adam state and
    step, each on the device of the state's parameters) and return it;
    without a checkpoint, return `state` unchanged (reference
    state.py:181-201). Under torch.distributed every rank must see the
    same latest step (_assert_step_agreement)."""
    step = latest_checkpoint_step(checkpoint_dir)
    _assert_step_agreement(step)
    if step is None:
        return state
    payload = _load(checkpoint_dir, step)
    state.params.load_state_dict(payload['params'])
    state.opt.load_state_dict(payload['opt_state'])
    state.step = int(payload['step'])
    return state


def restore_params(checkpoint_dir, params_template=None):
    """The params of the latest checkpoint (reference state.py:204-215): a
    state_dict on the host, or, given a NeRFParams module, that module
    with the state_dict loaded into it. Raises FileNotFoundError when
    there is no checkpoint."""
    step = latest_checkpoint_step(checkpoint_dir)
    if step is None:
        raise FileNotFoundError(f'no checkpoint under {checkpoint_dir}')
    params = _load(checkpoint_dir, step)['params']
    if params_template is None:
        return params
    params_template.load_state_dict(params)
    return params_template
