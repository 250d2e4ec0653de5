"""Training of the coarse stream: losses, SGD with the fusion group and
the learning-rate schedules, the train state and the train/eval steps
(counterpart of ``coarse_fine_networks_tpu/train``; the drivers, the data
pipeline and checkpoints are not ported yet)."""

from .losses import bce_loss, detection_loss
from .optim import (CosineSchedule, MultiStepSchedule, build_schedule,
                    fusion_lr_scale, make_optimizer)
from .state import TrainState
from .steps import (bn_aggregated, crop_reduced_loss, make_eval_step,
                    make_train_step, t_chunks)

__all__ = [
    "CosineSchedule",
    "MultiStepSchedule",
    "TrainState",
    "bce_loss",
    "bn_aggregated",
    "build_schedule",
    "crop_reduced_loss",
    "detection_loss",
    "fusion_lr_scale",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "t_chunks",
]
