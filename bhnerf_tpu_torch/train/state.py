"""Training state and the Adam + polynomial learning-rate schedule.

PyTorch counterpart of `bhnerf_tpu/train/state.py` (:30-83): Adam whose
learning rate follows optax.polynomial_schedule(lr_init, lr_final, 1,
num_iters), a linear decay counted from update 0. The separate learning
rate for the injection offset and checkpoints are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamSchedule:
    """What make_optimizer returns: Adam (b1 0.9, b2 0.999, eps 1e-8, as
    optax.adam) with a linear learning-rate decay."""

    num_iters: int = 5000
    lr_init: float = 1e-4
    lr_final: float = 1e-6

    def lr(self, count):
        """optax.polynomial_schedule(lr_init, lr_final, power=1,
        transition_steps=num_iters) at update `count` (0-based)."""
        frac = 1.0 - min(count, self.num_iters) / self.num_iters
        return (self.lr_init - self.lr_final) * frac + self.lr_final

    def build(self, params):
        """torch.optim.Adam over the parameters of `params` (nn.Module)."""
        return torch.optim.Adam(params.parameters(), lr=self.lr(0),
                                betas=(0.9, 0.999), eps=1e-8)


def make_optimizer(num_iters=5000, lr_init=1e-4, lr_final=1e-6):
    """Adam + polynomial schedule (reference network.py:171-180)."""
    return AdamSchedule(num_iters, lr_init, lr_final)


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
            group['lr'] = self.tx.lr(self.step)
        self.opt.step()
        self.step += 1
