"""Training state and the Adam + polynomial learning-rate schedule.

PyTorch counterpart of `bhnerf_tpu/train/state.py` (:30-83): Adam whose
learning rate follows optax.polynomial_schedule(lr_init, lr_final, 1,
num_iters), a linear decay counted from update 0, and optionally a
separate constant learning rate for the learnable injection offset.
Checkpoints are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch


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
