"""Training of both streams: losses, SGD with the fusion group and the
learning-rate schedules, the train state, the train/eval steps, the
multigrid long cycle, the device batch, checkpoints with resume, and the
drivers, configured by :class:`.config.DriverConfig`: Kinetics-style
pretraining (:mod:`.kinetics_driver`), the fine stream under the long
cycle (:mod:`.fine_driver`), feature extraction (:mod:`.extract_driver`)
and the coarse stream (:mod:`.coarse_driver`) (counterpart of
``coarse_fine_networks_tpu/train``)."""

from .common import (batch_shape_key, iter_train_batches, load_pretrained,
                     maybe_resume, model_batch, preemption_guard,
                     prepare_clips, save_train_state, stack_microbatches)
from .config import DriverConfig
from .losses import bce_loss, detection_loss
from .multigrid import (DEFAULT_LONG_CYCLE, LongCyclePhase, LongCycleRunner,
                        LongCycleSchedule)
from .optim import (CosineSchedule, MultiStepSchedule, build_schedule,
                    fusion_lr_scale, make_optimizer)
from .state import TrainState
from .steps import (bn_aggregated, crop_reduced_loss, make_eval_step,
                    make_train_step, t_chunks)

__all__ = [
    "CosineSchedule",
    "DEFAULT_LONG_CYCLE",
    "DriverConfig",
    "LongCyclePhase",
    "LongCycleRunner",
    "LongCycleSchedule",
    "MultiStepSchedule",
    "TrainState",
    "batch_shape_key",
    "bce_loss",
    "bn_aggregated",
    "build_schedule",
    "crop_reduced_loss",
    "detection_loss",
    "fusion_lr_scale",
    "iter_train_batches",
    "load_pretrained",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "maybe_resume",
    "model_batch",
    "preemption_guard",
    "prepare_clips",
    "save_train_state",
    "stack_microbatches",
    "t_chunks",
]
