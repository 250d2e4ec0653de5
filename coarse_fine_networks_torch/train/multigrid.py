"""X3D multigrid long-cycle schedule (counterpart of
``coarse_fine_networks_tpu/train/multigrid.py``).

The long cycle moves through (short + small, short + larger, long + base
crop at half the frames, base) clip shapes with the batch scaled to keep
the work per step about constant, and rebuilds the batch-norm splits at
each transition (the reference's dormant ``update_bn_splits_long_cycle``
hook).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from torch import nn

from ..models.surgery import set_bn_splits


@dataclasses.dataclass(frozen=True)
class LongCyclePhase:
    frames_scale: float   # temporal length multiplier
    crop_scale: float     # spatial side multiplier
    batch_scale: int      # batch multiplier (keeps tokens/step ~constant)
    bn_split_scale: int   # batch-norm split multiplier


DEFAULT_LONG_CYCLE: List[LongCyclePhase] = [
    LongCyclePhase(0.25, 0.5, 8, 8),
    LongCyclePhase(0.5, 0.707, 4, 4),
    LongCyclePhase(0.5, 1.0, 2, 2),
    LongCyclePhase(1.0, 1.0, 1, 1),
]


class LongCycleSchedule:
    """Long-cycle phases across training epochs."""

    def __init__(self, base_frames: int, base_crop: int, base_batch: int,
                 epochs_per_phase: int = 1,
                 phases: Optional[List[LongCyclePhase]] = None):
        self.base = (base_frames, base_crop, base_batch)
        self.phases = phases or DEFAULT_LONG_CYCLE
        self.epochs_per_phase = epochs_per_phase

    def phase(self, epoch: int) -> LongCyclePhase:
        i = (epoch // self.epochs_per_phase) % len(self.phases)
        return self.phases[i]

    def shapes(self, epoch: int) -> Tuple[int, int, int]:
        """``(frames, crop_size, batch_size)`` for this epoch: the dataset's
        window and crop, and the loader's batch."""
        p = self.phase(epoch)
        f, c, b = self.base
        frames = max(int(f * p.frames_scale), 1)
        crop = int(c * p.crop_scale) // 16 * 16 or 16
        return frames, crop, b * p.batch_scale

    def transition(self, epoch: int, model: nn.Module,
                   base_splits: int = 1) -> int:
        """At a phase boundary, give ``model``'s batch norms the phase's
        absolute split count ``base_splits · bn_split_scale`` with fresh
        split statistics (:func:`..models.surgery.set_bn_splits`), in place;
        returns the split count."""
        splits = base_splits * self.phase(epoch).bn_split_scale
        set_bn_splits(model, splits)
        return splits


class LongCycleRunner:
    """A :class:`LongCycleSchedule` applied to a driver's input and model
    epoch by epoch (the JAX drivers' ``mg_apply``): the dataset's clip
    window (the schedule's frames × ``window_scale``: the Charades dataset
    counts its window in frames at twice the clip stride) and crop, the
    train loader's batch, and at a split change the model's batch-norm
    splits with fresh split statistics, in place (the optimizer and the
    train and eval steps hold the same module, so they follow it).
    :attr:`phases` records each phase applied, as ``(epoch, frames, crop,
    batch, splits)``."""

    def __init__(self, schedule: LongCycleSchedule, loader, model: nn.Module,
                 base_splits: int = 1, window_scale: int = 1):
        self.schedule = schedule
        self.loader = loader
        self.model = model
        self.base_splits = base_splits
        self.window_scale = window_scale
        self.phases: List[tuple] = []
        self._applied: tuple = (None, None)  # ((frames, crop, batch), splits)

    def apply(self, epoch: int) -> int:
        """Set epoch ``epoch``'s phase up (nothing if it is the one applied
        last); returns its batch size."""
        shapes = self.schedule.shapes(epoch)
        splits = self.base_splits * self.schedule.phase(epoch).bn_split_scale
        if (shapes, splits) == self._applied:
            return shapes[2]
        frames, crop, batch = shapes
        ds = self.loader.dataset
        ds.frames = frames * self.window_scale
        ds.crop_size = crop
        self.loader.batch_size = batch
        if splits != (self._applied[1] or self.base_splits):
            self.schedule.transition(epoch, self.model, self.base_splits)
        self._applied = (shapes, splits)
        self.phases.append((epoch, frames, crop, batch, splits))
        return batch
