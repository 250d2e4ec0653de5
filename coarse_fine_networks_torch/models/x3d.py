"""X3D trunk building blocks, channels-last ``(B, T, H, W, C)``.

Counterpart of ``coarse_fine_networks_tpu/models/x3d.py`` and
``models/x3d_fold.py``.  The fold4 layout and the space-to-depth stem of the
JAX package are TPU mechanics and are not ported: ``conv1_s`` is a plain
strided conv, and every bottleneck (not only layer1's) enters conv2 through
a hand-written kernel, by the routes of the JAX package's
``FoldedBottleneck``:

* eval: :func:`..ops.dw_mm_act.dw_mm_bnrelu_conv3d_train` (conv1 → bn1 →
  relu → conv2 in one kernel, with the JAX package's backward of it);
* training, ``bn1.num_splits == 1``: conv1 as a product, then
  :func:`..ops.dw_act.dw_bnrelu_conv3d_train` (bn1 apply from the batch
  statistics → relu → conv2, with a kernel backward);
* training, ``bn1.num_splits == 1`` with ``CFN_MM_BN_TRAIN`` set
  (:func:`..ops.dw_mm_bn_train.resolve_mm_train`: ``1``, or ``s1`` for the
  stride-1 blocks): :meth:`.layers.SubBatchNorm.train_mm_entry`, conv1 →
  bn1's batch statistics → relu → conv2 as one composite
  (:func:`..ops.dw_mm_bn_train.mm_bn_train`: the eval entry's kernel
  forward, statistics from the Gram of x, the kernel backward with the
  batch-norm gradient in closed form), so conv1's output is never
  materialised;
* training with split batch norm (``bn1.num_splits > 1``, the multigrid
  long cycle): conv1 as a product → bn1 per split → relu in PyTorch, then
  :func:`..ops.dw_conv.dw_conv3d_train` (conv2, with a kernel backward);
* ``t_downsample`` (the fine stream's option: every stage's block 0
  strides T too, at (2, 2, 2)): that block takes the split route's
  composite in every mode, eval and training at any split count, with
  conv2 at (2, 2, 2) (``dw_conv_t2`` and its backward), as the JAX package
  runs ``t_downsample`` on its plain layout; its downsample reads
  ``x[:, ::2, ::2, ::2]``.

With ``remat`` each bottleneck of a stage runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are recomputed
in the backward instead of kept, as the JAX package wraps ``Bottleneck`` in
``nn.remat``.  The recomputation runs under
:func:`.layers.frozen_stats`, so every batch norm's statistics move once a
step, as the JAX package's functional state does.

The stem's depthwise temporal ``conv1_t`` (5×1×1) runs through
:func:`..ops.dw_stencil.depthwise_conv3d` in eval and in training (the
port of K11, with a kernel backward); ``conv1_s`` stays a plain conv, as in
the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.dw_act import dw_bnrelu_conv3d_train
from ..ops.dw_conv import dw_conv3d_train
from ..ops.dw_mm_act import dw_mm_bnrelu_conv3d_train
from ..ops.dw_mm_bn_train import resolve_mm_train
from ..ops.dw_stencil import depthwise_conv3d
from .layers import (SubBatchNorm, conv3d, frozen_stats, pointwise,
                     round_width, squeeze_excite, swish)


def get_inplanes(version: str) -> list[tuple[int, int]]:
    """(mid, out) channel widths per stage."""
    planes = {
        "S": [(54, 24), (108, 48), (216, 96), (432, 192)],
        "M": [(54, 24), (108, 48), (216, 96), (432, 192)],
        "XL": [(72, 32), (162, 72), (306, 136), (630, 280)],
    }
    return planes[version]


def get_blocks(version: str) -> list[int]:
    """Bottlenecks per stage."""
    blocks = {"S": [3, 5, 11, 7], "M": [3, 5, 11, 7], "XL": [5, 10, 25, 15]}
    return blocks[version]


class Bottleneck(nn.Module):
    """X3D bottleneck: 1×1×1 expand → depthwise 3³ at stride (1,s,s) → SE
    (even blocks) → swish → 1×1×1 project → residual + ReLU.

    bn1 folds into f32 ``(sc, bi)``: in eval from its running statistics,
    and the entry conv1 → bn1 → relu → conv2 runs as one kernel with a
    backward; in training from the batch statistics of conv1's output,
    inside autograd, and bn1 → relu → conv2 runs as one kernel with a kernel
    backward, or, with ``CFN_MM_BN_TRAIN`` set for this stride, the whole
    entry runs as the eval kernel with the statistics taken from x's Gram
    and a closed-form backward.  With split batch norm
    (``bn1.num_splits > 1``) each split has its own statistics, so training
    applies bn1 and the relu in PyTorch (the result in x's dtype, as the JAX
    package rounds it) and only conv2 runs as a kernel, with a kernel
    backward.  With ``t_downsample`` a strided block strides T too, (2, 2,
    2), and takes that last route in every mode.

    ``se_planes`` (default ``mid_planes``) is the width the SE squeeze is
    rounded from (:func:`.layers.round_width`): a ``channel_pad`` tower
    passes the unpadded mid width, so its SE convs are the unpadded
    tower's up to zero blocks."""

    def __init__(self, in_planes: int, mid_planes: int, out_planes: int,
                 stride: int = 1, use_se: bool = False,
                 has_downsample: bool = False, t_downsample: bool = False,
                 se_planes: int | None = None):
        super().__init__()
        s = stride
        self.stride = stride
        # the temporal stride: the fine stream's t_downsample strides T as H
        self.t_stride = st = s if t_downsample else 1
        self.conv1 = nn.Conv3d(in_planes, mid_planes, 1, bias=False)
        self.bn1 = SubBatchNorm(mid_planes)
        self.conv2 = nn.Conv3d(mid_planes, mid_planes, 3, stride=(st, s, s),
                               padding=1, groups=mid_planes, bias=False)
        self.bn2 = SubBatchNorm(mid_planes)
        self.use_se = use_se
        if use_se:
            width = round_width(se_planes or mid_planes)
            self.fc1 = nn.Conv3d(mid_planes, width, 1, bias=True)
            self.fc2 = nn.Conv3d(width, mid_planes, 1, bias=True)
        self.conv3 = nn.Conv3d(mid_planes, out_planes, 1, bias=False)
        self.bn3 = SubBatchNorm(out_planes)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                nn.Conv3d(in_planes, out_planes, 1, stride=(st, s, s),
                          bias=False),
                SubBatchNorm(out_planes))

    def _w1(self, dtype: torch.dtype) -> torch.Tensor:
        """conv1's weight as the ``(C_in, C_mid)`` matrix of the fused
        entries."""
        return (self.conv1.weight.reshape(self.conv1.out_channels, -1).t()
                .to(dtype).contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c_mid = self.conv1.out_channels
        w_dw = (self.conv2.weight.reshape(c_mid, 27).t()
                .reshape(3, 3, 3, c_mid).to(x.dtype).contiguous())
        one_split = self.bn1.num_splits == 1
        if self.t_stride > 1:
            out = torch.relu(self.bn1(pointwise(x, self.conv1.weight)))
            out = dw_conv3d_train(out, w_dw, (self.t_stride, self.stride,
                                              self.stride))
        elif not self.training:
            sc, bi = self.bn1.scale_bias()
            out = dw_mm_bnrelu_conv3d_train(x, self._w1(x.dtype), w_dw, sc,
                                            bi, self.stride)
        elif one_split and resolve_mm_train(self.stride):
            out = self.bn1.train_mm_entry(x, self._w1(x.dtype), w_dw,
                                          self.stride)
        elif one_split:
            out = pointwise(x, self.conv1.weight)
            sc, bi = self.bn1.train_scale_bias(out)
            out = dw_bnrelu_conv3d_train(out, w_dw, sc, bi, self.stride)
        else:
            out = torch.relu(self.bn1(pointwise(x, self.conv1.weight)))
            out = dw_conv3d_train(out, w_dw, self.stride)
        out = self.bn2(out)
        if self.use_se:
            out = squeeze_excite(out, self.fc1, self.fc2)
        out = swish(out)
        out = self.bn3(pointwise(out, self.conv3.weight))
        residual = x
        if self.downsample is not None:
            s, st = self.stride, self.t_stride
            residual = pointwise(x[:, ::st, ::s, ::s],
                                 self.downsample[0].weight)
            residual = self.downsample[1](residual)
        return torch.relu(out + residual)


def remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    activations inside are recomputed in the backward instead of kept.  The
    recomputation runs under :func:`.layers.frozen_stats`, so the block's
    batch norms update their statistics only in the first run.  No RNG
    state is kept: a bottleneck draws no random numbers."""
    runs = []

    def run(inp):
        runs.append(None)
        if len(runs) == 1:
            return block(inp)
        with frozen_stats():
            return block(inp)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class X3DStage(nn.Sequential):
    """A residual stage: block 0 strides (``t_downsample``: T too) and
    carries the downsample; SE on even-indexed blocks.  Blocks are named
    ``0, 1, ...`` (``layerN.M``).  With ``remat``, each block runs through
    :func:`remat_block` whenever gradients are taken (as ``nn.remat``
    recomputes under any differentiation, in eval mode too)."""

    def __init__(self, in_planes: int, mid_planes: int, out_planes: int,
                 num_blocks: int, stride: int = 2, t_downsample: bool = False,
                 remat: bool = False, se_planes: int | None = None):
        super().__init__(*[
            Bottleneck(in_planes if i == 0 else out_planes, mid_planes,
                       out_planes, stride=stride if i == 0 else 1,
                       use_se=(i % 2 == 0), has_downsample=(i == 0),
                       t_downsample=t_downsample, se_planes=se_planes)
            for i in range(num_blocks)])
        self.remat = remat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rematted = self.remat and torch.is_grad_enabled()
        for block in self:
            x = remat_block(block, x) if rematted else block(x)
        return x


class X3DStem(nn.Module):
    """Stem: spatial ``conv1_s`` (1×3×3, stride (1,2,2)) → depthwise temporal
    ``conv1_t`` (5×1×1) → ``bn1`` → relu.

    ``conv1_t`` runs through :func:`..ops.dw_stencil.depthwise_conv3d` (the
    kernel K11 and its backward on the card) with its weight ``(C, 1, 5, 1,
    1)`` as taps ``(5, 1, 1, C)`` in x's dtype; the parameters keep the
    reference's names and shapes.  The towers keep these three modules at
    their own top level, under the reference's names, and run
    :meth:`forward` on themselves."""

    def __init__(self, planes: int, in_channels: int = 3):
        super().__init__()
        self.conv1_s = nn.Conv3d(in_channels, planes, (1, 3, 3),
                                 stride=(1, 2, 2), padding=(0, 1, 1),
                                 bias=False)
        self.conv1_t = nn.Conv3d(planes, planes, (5, 1, 1), padding=(2, 0, 0),
                                 groups=planes, bias=False)
        self.bn1 = SubBatchNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv3d(x, self.conv1_s)
        w = self.conv1_t.weight
        taps = (w.reshape(w.shape[0], -1).t().reshape(*w.shape[2:], -1)
                .to(x.dtype).contiguous())
        x = depthwise_conv3d(x, taps)
        return torch.relu(self.bn1(x))


class X3DHead(nn.Module):
    """``conv5`` (1×1×1) → ``bn5`` → relu.  Kept at the towers' top level
    like :class:`X3DStem`."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.conv5 = nn.Conv3d(in_planes, out_planes, 1, bias=False)
        self.bn5 = SubBatchNorm(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn5(pointwise(x, self.conv5.weight)))


def pad_width(width: int, multiple: int) -> int:
    """``width`` rounded up to a multiple of ``multiple`` (tensor-parallel
    channel padding)."""
    return -(-width // multiple) * multiple


class X3DTrunk(nn.Module):
    """Stem, four stages and head with the reference's top-level names
    (``conv1_s``, ``conv1_t``, ``bn1``, ``layer1``–``layer4``, ``conv5``,
    ``bn5``), shared by :class:`..fine.FineNet` and
    :class:`..coarse.CoarseNet`; ``t_downsample`` and ``remat`` go to every
    stage (:class:`X3DStage`).

    ``channel_pad > 1`` rounds every mid width and the head's width up to
    a multiple of it (:func:`pad_width`), so that each tensor-parallel
    shard of them has the same width (:mod:`..parallel.tensor`); the SE
    squeeze stays ``round_width`` of the unpadded mid.  With the padded
    parameters zero (batch-norm variances one) the extra channels are
    inert in eval, as in the JAX package's ``channel_pad``."""

    def __init__(self, version: str = "M", t_downsample: bool = False,
                 remat: bool = False, channel_pad: int = 1):
        super().__init__()
        planes, blocks = get_inplanes(version), get_blocks(version)
        self.channel_pad = channel_pad
        stem = X3DStem(planes[0][1])
        self.conv1_s, self.conv1_t, self.bn1 = (stem.conv1_s, stem.conv1_t,
                                                stem.bn1)
        in_planes = planes[0][1]
        for i, ((mid, out), n) in enumerate(zip(planes, blocks)):
            self.add_module(f"layer{i + 1}",
                            X3DStage(in_planes, pad_width(mid, channel_pad),
                                     out, n, stride=2,
                                     t_downsample=t_downsample, remat=remat,
                                     se_planes=mid))
            in_planes = out
        head = X3DHead(planes[3][1], pad_width(planes[3][0], channel_pad))
        self.conv5, self.bn5 = head.conv5, head.bn5

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return X3DStem.forward(self, x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return X3DHead.forward(self, x)
