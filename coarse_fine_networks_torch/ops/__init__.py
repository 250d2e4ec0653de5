"""Numeric ops of the port: plain PyTorch functions on channels-last
tensors, the hand-written bottleneck-entry kernels (:mod:`.dw_mm_act`
for eval, :mod:`.dw_act` for training, :mod:`.dw_conv` for training with
split batch norm, :mod:`.dw_mm_bn_train` for the matmul-fused training
composite), and the plain-layout depthwise conv :mod:`.dw_stencil`
(``depthwise_conv3d``: the stem's ``conv1_t`` on every path, through the
kernels K11 and K7)."""

from .dw_act import (dw_act_dx, dw_act_wgrad, dw_bnrelu_conv3d,
                     dw_bnrelu_conv3d_train)
from .dw_conv import (dw_conv3d, dw_conv3d_train, dw_conv_dx_s2,
                      dw_conv_wgrad)
from .dw_mm_act import (dw_mm_bnrelu_conv3d, dw_mm_bnrelu_conv3d_plain,
                        dw_mm_bnrelu_conv3d_train, dw_mm_wgrad)
from .dw_mm_bn_train import (dw_mm_dx_mask, mm_bn_stats, mm_bn_train,
                             resolve_mm_train)
from .dw_stencil import (DwStencil3d, depthwise_conv3d, dw_stencil3d,
                         dw_stencil3d_plain, dw_stencil_wgrad,
                         dw_stencil_wgrad_plain)
from .gaussian import gaussian_alignment
from .grid_pool import cdf_knots
from .pools import (adaptive_avg_pool_spatial, adaptive_max_pool_spatial,
                    spatial_replicate)
from .resample import (hat_matrix, interp1d, inverse_cdf, linear_resize,
                       temporal_resample)
from .reweight import reweight_aggregate

__all__ = [
    "DwStencil3d",
    "adaptive_avg_pool_spatial",
    "adaptive_max_pool_spatial",
    "cdf_knots",
    "depthwise_conv3d",
    "dw_act_dx",
    "dw_act_wgrad",
    "dw_bnrelu_conv3d",
    "dw_bnrelu_conv3d_train",
    "dw_conv3d",
    "dw_conv3d_train",
    "dw_conv_dx_s2",
    "dw_conv_wgrad",
    "dw_mm_bnrelu_conv3d",
    "dw_mm_bnrelu_conv3d_plain",
    "dw_mm_bnrelu_conv3d_train",
    "dw_mm_dx_mask",
    "dw_mm_wgrad",
    "dw_stencil3d",
    "dw_stencil3d_plain",
    "dw_stencil_wgrad",
    "dw_stencil_wgrad_plain",
    "gaussian_alignment",
    "hat_matrix",
    "interp1d",
    "inverse_cdf",
    "linear_resize",
    "mm_bn_stats",
    "mm_bn_train",
    "resolve_mm_train",
    "reweight_aggregate",
    "spatial_replicate",
    "temporal_resample",
]
