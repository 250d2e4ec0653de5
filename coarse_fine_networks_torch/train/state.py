"""Train state: the model (parameters and batch-norm statistics), its
optimizer (momentum buffers) and the step count (counterpart of
``coarse_fine_networks_tpu/train/state.py``)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .optim import make_optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module) -> "TrainState":
        """Fresh state: zero momentum, step 0.  Momentum and weight decay
        are set by the train step."""
        return cls(model=model, optimizer=make_optimizer(model))
