"""Training of both streams: losses, SGD with the fusion group and the
learning-rate schedules, the train state, the train/eval steps, the
multigrid long cycle and the device batch (counterpart of
``coarse_fine_networks_tpu/train``; the drivers, the host data pipeline and
checkpoints are not ported yet)."""

from .common import model_batch, prepare_clips

from .losses import bce_loss, detection_loss
from .multigrid import DEFAULT_LONG_CYCLE, LongCyclePhase, LongCycleSchedule
from .optim import (CosineSchedule, MultiStepSchedule, build_schedule,
                    fusion_lr_scale, make_optimizer)
from .state import TrainState
from .steps import (bn_aggregated, crop_reduced_loss, make_eval_step,
                    make_train_step, t_chunks)

__all__ = [
    "CosineSchedule",
    "DEFAULT_LONG_CYCLE",
    "LongCyclePhase",
    "LongCycleSchedule",
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
    "model_batch",
    "prepare_clips",
    "t_chunks",
]
