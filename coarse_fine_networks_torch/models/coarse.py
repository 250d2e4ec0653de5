"""Coarse-stream X3D with Grid Pool / Unpool and multi-stage fusion
(counterpart of ``coarse_fine_networks_tpu/models/coarse.py``).

The serving and the coarse driver use ``t_pool='grid'``, learned mixing
and ``is_mixing=True``; the JAX package's other options are the paper's
Grid Pool ablations: ``t_pool`` ``avg``, ``max`` (window 4, stride 4,
VALID), ``stride`` (every 4th frame) or ``None`` (no temporal pooling),
none of which has knots or an unpool; ``learned_mixing=False`` (each stage
takes the level of its own width); ``is_mixing=False`` (the per-level maps
applied directly, the scale through a sigmoid); ``task='class'`` (the
head's features averaged over T too) and ``remat``.  Only the modules the
configuration uses are built, as in the JAX package: no ``pool_1`` without
Grid Pool, no ``mix*`` without learned mixing.  The fusion branch runs at
the fine features' canonical 7×7 and its final scale/bias maps are
replicated to each stage's resolution, which is exact because every op in
the reference's replicate → 1×1 conv → pool chain is pointwise or
replication-compatible.  Logits are time-major ``(B, T_c, n_classes)``:
T_c = T with Grid Pool (after the unpool) or without pooling, T/4 with the
fixed pools.

In training, dropout (rate ``dropout_rate``) follows the relu of ``rw6``'s
``fc1``/``fc3`` and of the head's ``fc1``, where the JAX package puts it;
its mask is drawn from the ``generator`` passed to :meth:`CoarseNet.forward`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.gaussian import gaussian_alignment
from ..ops.grid_pool import cdf_knots
from ..ops.pools import (adaptive_max_pool_spatial, spatial_replicate,
                         temporal_pool)
from ..ops.resample import inverse_cdf, linear_resize, temporal_resample
from ..ops.reweight import reweight_aggregate
from .layers import SubBatchNorm, conv3d, dropout, pointwise
from .x3d import X3DTrunk, get_inplanes

DEFAULT_FEAT_DEPTH = {
    "layer1": 24, "layer2": 48, "layer3": 96, "layer4": 192, "conv5": 432,
}


class GridPool(nn.Module):
    """Learned temporal downsampler: a conv score head predicts per-region
    confidence, ``1 - p`` becomes a sampling CDF, and the features are
    resampled linearly at its knots.  Returns
    ``(pooled (B, T/ratio + 1, H, W, C), knots (B, T/ratio + 1))``."""

    def __init__(self, depth: int, ratio: int = 4):
        super().__init__()
        r2 = ratio // 2
        self.conv1 = nn.Conv3d(depth, depth, 3, stride=(r2, 2, 2), padding=1)
        self.bn1 = SubBatchNorm(depth)
        self.conv2 = nn.Conv3d(depth, depth, 3, stride=(r2, 2, 2), padding=1)
        self.bn2 = SubBatchNorm(depth)
        self.conv3 = nn.Conv3d(depth, 1, (1, 3, 3), stride=(1, 2, 2),
                               padding=(0, 1, 1))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        t = x.shape[1]
        g = torch.relu(self.bn1(conv3d(x, self.conv1)))
        g = torch.relu(self.bn2(conv3d(g, self.conv2)))
        g = conv3d(g, self.conv3)
        scores = torch.mean(g, dim=(2, 3))[..., 0]
        knots = cdf_knots(scores.float())
        pooled = temporal_resample(x, knots.to(x.dtype) * (t - 1))
        return pooled, knots


def grid_unpool_logits(logits: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """Invert Grid Pool on ``(B, K, C)`` logits, then upsample ×4 linearly:
    ``(B, (K-1)·4, C)``."""
    k = knots.shape[1]
    inv = inverse_cdf(knots)
    out = temporal_resample(logits, inv.to(logits.dtype) * (k - 1))
    return linear_resize(out, (k - 1) * 4, align_corners=True)


def _dense(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    return pointwise(x, conv.weight, conv.bias)


class RewightLayer(nn.Module):
    """Attention-filtered, Gaussian-aligned aggregation of one fine feature
    bank (``in_channels`` wide, ``depth`` unless given) into per-stage
    ``(bias, scale)`` maps ``(B, T_c, 7, 7, channels)`` (1×1 with
    ``pool=True``, the logit-level ``rw6``).  The heads are the reference's
    kernel-1 ``Conv1d``s, applied over channels, with ``depth`` hidden
    channels (the JAX package's ``Dense(depth)`` on the bank: at X3D-XL's
    widths the banks are wider than the default depths); with ``pool``
    their hidden activations take dropout in training."""

    def __init__(self, channels: int, depth: int, pool: bool = False,
                 dropout_rate: float = 0.5, in_channels: int | None = None):
        super().__init__()
        self.pool = pool
        self.dropout_rate = dropout_rate
        c_in = depth if in_channels is None else in_channels
        self.at1 = nn.Conv1d(c_in, depth, 1)
        self.at2 = nn.Conv1d(depth, 1, 1)
        self.fc1 = nn.Conv1d(c_in, depth, 1)
        self.fc2 = nn.Conv1d(depth, channels, 1)
        self.fc3 = nn.Conv1d(c_in, depth, 1)
        self.fc4 = nn.Conv1d(depth, channels, 1)

    def forward(self, feat: torch.Tensor, mask: torch.Tensor,
                align: torch.Tensor, is_mixing: bool,
                generator: torch.Generator | None = None):
        if feat.shape[1] != mask.shape[1]:
            raise ValueError(f"fine-feature length {feat.shape[1]} != mask "
                             f"{mask.shape[1]}")
        gate = torch.sigmoid(_dense(torch.relu(_dense(feat, self.at1)),
                                    self.at2))[..., 0]
        x = reweight_aggregate(feat, gate, align.to(feat.dtype), mask)
        rate = self.dropout_rate if self.pool and self.training else 0.0
        if self.pool:
            x = torch.mean(x, dim=(2, 3), keepdim=True)
        bias = _dense(dropout(torch.relu(_dense(x, self.fc1)), rate,
                              generator), self.fc2)
        scale = _dense(dropout(torch.relu(_dense(x, self.fc3)), rate,
                               generator), self.fc4)
        if not is_mixing:
            scale = torch.sigmoid(scale)
        return bias, scale


MIX_LEVELS = (24, 48, 96, 192)  # the four maps' widths (JAX: MIX_LEVELS)


class MixingLayer(nn.Module):
    """Learned mixing of the four per-level bias/scale maps into one
    stage-conditioned ``(bias, scale)``.  The reference pools each map to
    the stage resolution before the mixing conv; at ``out_hw >= 7`` that
    commutes with the pointwise conv and the maps stay at 7×7, below it the
    maps are pooled first.  (Without learned mixing a stage takes the level
    of its own width, ``MIX_LEVELS``; that has no parameters, so no
    module.)"""

    def __init__(self, depth: int, in_channels: int = 360):
        super().__init__()
        self.conv_at = nn.Conv1d(in_channels, depth, 1)
        self.conv_at2 = nn.Conv1d(in_channels, depth, 1)

    def forward(self, bias_list, scale_list, out_hw: int):
        if out_hw < 7:
            bias_list = [adaptive_max_pool_spatial(b, out_hw)
                         for b in bias_list]
            scale_list = [adaptive_max_pool_spatial(s, out_hw)
                          for s in scale_list]
        cs = _dense(torch.cat(list(bias_list), dim=-1), self.conv_at)
        ms = torch.sigmoid(_dense(torch.cat(list(scale_list), dim=-1),
                                  self.conv_at2))
        return cs, ms


T_POOLS = ("avg", "max", "stride", "grid", None)


class CoarseNet(X3DTrunk):
    """Coarse stream: X3D trunk + temporal pooling (Grid Pool by default) +
    multi-stage fusion of the fine feature banks (+ Grid Unpool).

    ``crops`` (an attribute the eval loop may set): multi-crop testing,
    where ``x`` carries ``crops`` consecutive clips per sample, crop ``i``
    aligned ``i·stride`` fine frames later, and the per-sample fine banks
    are repeated per crop."""

    def __init__(self, version: str = "M", n_classes: int = 157,
                 feat_depth: dict[str, int] | None = None,
                 dropout_rate: float = 0.5, crops: int = 1,
                 t_pool: str | None = "grid", learned_mixing: bool = True,
                 is_mixing: bool = True, task: str = "loc",
                 remat: bool = False):
        super().__init__(version, remat=remat)
        if t_pool not in T_POOLS:
            raise ValueError(f"t_pool must be one of {T_POOLS}, got "
                             f"{t_pool!r}")
        if task not in ("loc", "class"):
            raise ValueError(f"task must be 'loc' or 'class', got {task!r}")
        self.dropout_rate = dropout_rate
        self.crops = crops
        self.t_pool = t_pool
        self.learned_mixing = learned_mixing
        self.is_mixing = is_mixing
        self.task = task
        planes = get_inplanes(version)
        fd = dict(DEFAULT_FEAT_DEPTH if feat_depth is None else feat_depth)
        if t_pool == "grid":
            self.pool_1 = GridPool(planes[0][1])
        # the fine tower's bank widths: each stage's output, and the head's
        for i, key in enumerate(("layer1", "layer2", "layer3", "layer4")):
            self.add_module(f"rw{i + 2}", RewightLayer(
                planes[i][1], fd[key], in_channels=planes[i][1]))
        self.rw6 = RewightLayer(n_classes, fd["conv5"], pool=True,
                                dropout_rate=dropout_rate,
                                in_channels=planes[3][0])
        n_mix = sum(p[1] for p in planes)
        if is_mixing and learned_mixing:
            for i in range(4):
                self.add_module(f"mix{i + 2}",
                                MixingLayer(planes[i][1], n_mix))
        self.fc1 = nn.Conv3d(planes[3][0], 2048, 1, bias=False)
        self.fc2 = nn.Linear(2048, n_classes)

    def forward(self, x: torch.Tensor, feats: dict[str, torch.Tensor],
                feat_mask: torch.Tensor, meta: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``x (B·crops, T, H, W, 3)``, feature banks ``(B, T_f, 7, 7,
        C_k)``, ``feat_mask (B, T_f)``, ``meta (B, 4)`` → f32 logits
        ``(B·crops, T_c, n_classes)`` (T_c: T, or T/4 with a fixed pool).
        ``generator`` draws the dropout masks in training (on x's device;
        needed when ``dropout_rate > 0``)."""
        t_in = x.shape[1]
        x = self.layer1(self.stem(x))
        knots = None
        if self.t_pool == "grid":
            x, knots = self.pool_1(x)
        elif self.t_pool is not None:
            x = temporal_pool(x, self.t_pool)
        # uniform coarse locations where there are no knots
        align = gaussian_alignment(meta, feat_mask, knots, t_in,
                                   coarse_len=x.shape[1], crops=self.crops)
        if self.crops > 1:
            feats = {k: torch.repeat_interleave(v, self.crops, dim=0)
                     for k, v in feats.items()}
            feat_mask = torch.repeat_interleave(feat_mask, self.crops, dim=0)

        rw_out = [getattr(self, f"rw{i + 2}")(feats[key].to(x.dtype),
                                              feat_mask, align,
                                              self.is_mixing)
                  for i, key in enumerate(("layer1", "layer2", "layer3",
                                           "layer4"))]
        bias_list = [b for b, _ in rw_out]
        scale_list = [s for _, s in rw_out]
        for i, stage in enumerate(("layer2", "layer3", "layer4", None)):
            hw = x.shape[2]
            if not self.is_mixing:
                cs, ms = bias_list[i], scale_list[i]
            elif self.learned_mixing:
                cs, ms = getattr(self, f"mix{i + 2}")(bias_list, scale_list,
                                                      hw)
            else:  # the JAX MixingLayer(learned=False): the stage's level
                level = MIX_LEVELS.index(x.shape[-1])
                cs, ms = bias_list[level], scale_list[level]
            x = x * spatial_replicate(ms, hw) + spatial_replicate(cs, hw)
            if stage is not None:
                x = getattr(self, stage)(x)

        axes = (1, 2, 3) if self.task == "class" else (2, 3)
        x = torch.mean(self.head(x), dim=axes)
        if self.task == "class":
            x = x[:, None]
        x = torch.relu(pointwise(x, self.fc1.weight))
        x = dropout(x, self.dropout_rate if self.training else 0.0, generator)
        logits = nn.functional.linear(x, self.fc2.weight.to(x.dtype),
                                      self.fc2.bias.to(x.dtype))
        rb, rs = self.rw6(feats["conv5"].to(x.dtype), feat_mask, align, False,
                          generator)
        logits = (logits * rs[:, :, 0, 0, :] + rb[:, :, 0, 0, :]).float()
        if knots is None:
            return logits
        return grid_unpool_logits(logits, knots)
