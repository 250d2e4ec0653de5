"""Model surgery, in place: the classifier swap for transfer learning and
the multigrid batch-norm split rebuild (counterpart of
``coarse_fine_networks_tpu/models/surgery.py``).

The JAX package rebuilds the statistics trees and clones its frozen flax
module with the new ``bn_splits``; here one call does both on the module.
The split statistics are buffers, not parameters, so an optimizer built on
the model holds no reference to them and keeps its momentum buffers.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import SubBatchNorm, _RunningStats


def _uniform_(t: torch.Tensor, bound: float,
              generator: torch.Generator) -> None:
    """``t ← U(−bound, bound)`` drawn from ``generator`` (on t's device)."""
    u = torch.rand(t.shape, generator=generator, device=generator.device)
    t.copy_(u * (2 * bound) - bound)


def _new_head(old: nn.Module, n_classes: int,
              generator: torch.Generator) -> nn.Module:
    """``old`` (an ``nn.Linear`` or a kernel-1 ``nn.Conv1d``) rebuilt with
    ``n_classes`` outputs and ``nn.Linear``'s default init, U(−1/√in,
    1/√in), for weight and bias, on old's device."""
    fan_in = old.weight.shape[1]
    if isinstance(old, nn.Conv1d):
        new = nn.Conv1d(fan_in, n_classes, 1)
    else:
        new = nn.Linear(fan_in, n_classes)
    new = new.to(old.weight.device)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        _uniform_(new.weight, bound, generator)
        _uniform_(new.bias, bound, generator)
    return new


def replace_logits(model: nn.Module, n_classes: int,
                   generator: torch.Generator) -> nn.Module:
    """Swap the classifier ``fc2`` for one with ``n_classes`` outputs, and
    in a model with a logit-fusion layer ``rw6`` (the coarse stream) its
    class-wide heads ``fc2`` and ``fc4``.  New weights are drawn from
    ``generator``.  The new parameters are not in an optimizer built
    before: make a new train state after the swap."""
    model.fc2 = _new_head(model.fc2, n_classes, generator)
    if hasattr(model, "rw6"):
        for name in ("fc2", "fc4"):
            setattr(model.rw6, name,
                    _new_head(getattr(model.rw6, name), n_classes, generator))
    return model


def _rebuild_splits(model: nn.Module, splits) -> nn.Module:
    """Every :class:`.layers.SubBatchNorm` ``m`` at ``splits(m)`` splits,
    with fresh split statistics (zero means, unit variances) on its
    device."""
    for m in model.modules():
        if isinstance(m, SubBatchNorm):
            m.num_splits = splits(m)
            m.split_bn = _RunningStats(m.num_splits * m.num_features).to(
                m.bn.running_mean.device)
    return model


def set_bn_splits(model: nn.Module, num_splits: int) -> nn.Module:
    """Give every :class:`.layers.SubBatchNorm` ``num_splits`` splits and
    fresh split statistics (``num_splits·C`` each), at an absolute split
    count (the long cycle moves 8 → 4 → 2 → 1).  The eval statistics ``bn``
    are kept."""
    return _rebuild_splits(model, lambda m: num_splits)


def update_bn_splits(model: nn.Module, scale: int) -> nn.Module:
    """The reference's long-cycle hook: every :class:`.layers.SubBatchNorm`
    at ``num_splits · scale`` splits with fresh split statistics."""
    return _rebuild_splits(model, lambda m: m.num_splits * scale)
