"""SGD with momentum and weight decay, the fusion parameter group and the
learning-rate schedules (counterpart of
``coarse_fine_networks_tpu/train/optim.py``).

The update is ``g += wd·p; buf = m·buf + g; p -= lr·buf`` — the JAX
package's ``sgd_update`` and ``torch.optim.SGD`` with ``dampening=0``, which
the port uses.  Parameters whose names contain ``rw`` or ``mix`` (the fusion
layers) form their own group, trained at ``fusion_lr_mult`` times the
learning rate by :func:`..steps.make_train_step`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
from torch import nn


def fusion_lr_scale(name: str, scale: float = 10.0) -> float:
    """``scale`` for fusion parameters (``'rw' in name or 'mix' in name``),
    else 1."""
    return scale if ("rw" in name or "mix" in name) else 1.0


def make_optimizer(model: nn.Module) -> torch.optim.SGD:
    """``torch.optim.SGD`` over ``model``'s parameters in two groups, the
    fusion parameters (``group["fusion"]``) and the rest, with the
    reference's momentum 0.9 and weight decay 1e-5; the train step sets
    each group's learning rate, momentum and weight decay before every
    update."""
    groups: Dict[bool, list] = {False: [], True: []}
    for name, p in model.named_parameters():
        groups[fusion_lr_scale(name) != 1.0].append(p)
    return torch.optim.SGD(
        [{"params": ps, "fusion": fusion} for fusion, ps in groups.items()
         if ps], lr=0.0, momentum=0.9, dampening=0.0, weight_decay=1e-5)


class MultiStepSchedule:
    """``MultiStepLR`` + linear warmup, host-side.

    ``milestones`` are scheduler-epoch counts (one scheduler step per
    validation phase); call :meth:`epoch_step` after each val phase and
    :meth:`lr` per optimisation step."""

    def __init__(self, init_lr: float, milestones: Sequence[int],
                 gamma: float = 0.1, warmup_steps: int = 0):
        self.init_lr = init_lr
        self.milestones = sorted(milestones)
        self.gamma = gamma
        self.warmup_steps = warmup_steps
        self.epoch = 0

    def epoch_step(self) -> None:
        self.epoch += 1

    def in_warmup(self, step: int) -> bool:
        """The warmup window: ``1 < step < warmup_steps``."""
        return 1 < step < self.warmup_steps

    def lr(self, step: int) -> float:
        # warmup scales init_lr, ignoring any decay already applied
        if self.in_warmup(step):
            return self.init_lr * min(1.0, float(step + 1) / self.warmup_steps)
        decays = sum(1 for m in self.milestones if self.epoch >= m)
        return self.init_lr * (self.gamma ** decays)

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.epoch = int(d["epoch"])


class CosineSchedule:
    """Half-period cosine decay with linear warmup, per optimisation step
    (the Kinetics pretraining policy); :meth:`epoch_step` is kept for
    interface parity with :class:`MultiStepSchedule`."""

    def __init__(self, init_lr: float, total_steps: int,
                 warmup_steps: int = 0, final_lr: float = 0.0):
        self.init_lr = init_lr
        self.total_steps = max(int(total_steps), 1)
        self.warmup_steps = warmup_steps
        self.final_lr = final_lr
        self.epoch = 0

    def epoch_step(self) -> None:
        self.epoch += 1

    def in_warmup(self, step: int) -> bool:
        return step < self.warmup_steps

    def lr(self, step: int) -> float:
        if self.warmup_steps and step < self.warmup_steps:
            return self.init_lr * float(step + 1) / self.warmup_steps
        span = max(self.total_steps - self.warmup_steps, 1)
        t = min(max(step - self.warmup_steps, 0) / span, 1.0)
        return self.final_lr + 0.5 * (self.init_lr - self.final_lr) * (
            1.0 + math.cos(math.pi * t))

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.epoch = int(d["epoch"])


def build_schedule(cfg, steps_per_epoch: int | None = None):
    """Schedule from a driver configuration (attributes ``lr_schedule``,
    ``init_lr``, ``warmup_steps``, ``lr_milestones``, ``total_steps``,
    ``max_steps``, ``max_epochs``, ``cosine_final_lr``):
    ``lr_schedule='multistep'`` or ``'cosine'``.  The cosine horizon is
    ``total_steps`` when set, else ``max_steps``, else
    ``max_epochs · steps_per_epoch``."""
    if cfg.lr_schedule == "cosine":
        total = cfg.total_steps or cfg.max_steps or (
            cfg.max_epochs * max(steps_per_epoch or 1, 1))
        return CosineSchedule(cfg.init_lr, total,
                              warmup_steps=cfg.warmup_steps,
                              final_lr=cfg.cosine_final_lr)
    if cfg.lr_schedule != "multistep":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    return MultiStepSchedule(cfg.init_lr, cfg.lr_milestones,
                             warmup_steps=cfg.warmup_steps)
