"""Models of the port: the shared X3D trunk, the fine stream (global tower
and training head), the coarse stream with Grid Pool / Unpool and fusion,
the joint pipeline, and model surgery."""

from .coarse import CoarseNet, GridPool, MixingLayer, RewightLayer
from .fine import FineNet
from .layers import (SqueezeExcite, SubBatchNorm, aggregate_sub_bn_stats,
                     frozen_stats, init_parameters, round_width, swish)
from .pipeline import CoarseFinePipeline
from .surgery import replace_logits, set_bn_splits, update_bn_splits
from .x3d import (Bottleneck, X3DHead, X3DStage, X3DStem, get_blocks,
                  get_inplanes)

__all__ = [
    "Bottleneck",
    "CoarseFinePipeline",
    "CoarseNet",
    "FineNet",
    "GridPool",
    "MixingLayer",
    "RewightLayer",
    "SqueezeExcite",
    "SubBatchNorm",
    "X3DHead",
    "X3DStage",
    "X3DStem",
    "aggregate_sub_bn_stats",
    "frozen_stats",
    "get_blocks",
    "get_inplanes",
    "init_parameters",
    "replace_logits",
    "round_width",
    "set_bn_splits",
    "swish",
    "update_bn_splits",
]
