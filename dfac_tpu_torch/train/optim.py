"""Optimizer policy and LR plateau scheduling.

Counterpart of :mod:`dfac_tpu.train.optim`:

* Optimizer selection (reference ``src/train.py:321-330``): AdamW with
  weight_decay defaulting to 0.01 for ``cnn*`` models, plain Adam
  otherwise; any explicit ``weight_decay > 0`` forces AdamW. optax's
  defaults: betas (0.9, 0.999), eps 1e-8 added after the square root,
  decay on every parameter (``p -= lr * (update + wd * p)``; torch's
  AdamW decays first, ``p *= 1 - lr * wd``, the same to rounding).
* ``ReduceLROnPlateau`` (reference ``src/train.py:332-341``) with torch's
  semantics: mode=min, relative threshold, patience in bad epochs, ``lr =
  max(lr * factor, min_lr)``; a dataclass with a ``state_dict`` that the
  checkpoints of both packages carry.
"""

from __future__ import annotations

import dataclasses

import torch

BETAS, EPS = (0.9, 0.999), 1e-8


def build_optimizer(model_name: str, params, lr: float, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """The reference's optimizer policy over ``params``."""
    wd = weight_decay
    if model_name.startswith("cnn") and wd == 0.0:
        wd = 0.01
    if wd > 0:
        return torch.optim.AdamW(params, lr=lr, betas=BETAS, eps=EPS, weight_decay=wd)
    return torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS)


def get_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_lr(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in opt.param_groups:
        group["lr"] = lr
    return opt


@dataclasses.dataclass
class PlateauScheduler:
    """torch ``ReduceLROnPlateau`` (mode=min, threshold_mode=rel)."""

    factor: float = 0.5
    patience: int = 2
    threshold: float = 1e-4
    min_lr: float = 1e-6
    cooldown: int = 0

    best: float | None = None
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def step(self, metric: float, lr: float) -> float:
        """Feed one epoch's monitored metric; returns the (possibly reduced) lr."""
        if self.best is None or metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            lr = max(lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: dict) -> "PlateauScheduler":
        return cls(**d)


def smooth_labels(labels, label_smoothing: float):
    """``y*(1-eps) + 0.5*eps`` (reference ``src/train.py:311-320``)."""
    if label_smoothing <= 0:
        return labels
    return labels * (1.0 - label_smoothing) + 0.5 * label_smoothing
