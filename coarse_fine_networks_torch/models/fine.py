"""Fine-stream X3D network (counterpart of
``coarse_fine_networks_tpu/models/fine.py``): the global tower the serving
pipeline extracts feature banks with, and the per-frame (``task='loc'``) or
per-clip (``task='class'``) logits and pooled features that fine-stream
training and ``extract_feat`` use.  ``t_downsample`` strides every stage's
first bottleneck in time too (at (2, 2, 2), the hand-written
``dw_conv_t2`` and its backward), so the stages run at T/2 … T/16;
``remat`` recomputes each bottleneck in the backward
(:class:`.x3d.X3DStage`).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pools import adaptive_avg_pool_spatial
from .layers import dropout, pointwise
from .x3d import X3DTrunk, get_inplanes, pad_width

# Spatial size of the global-tower feature taps.
TOWER_HW = 7
FEAT_KEYS = ("layer1", "layer2", "layer3", "layer4", "conv5")


class FineNet(X3DTrunk):
    """X3D fine stream, ``(B, T_f, H, W, 3)`` in, in one of three modes:

    * ``global_tower=True`` (the default, the serving pipeline's tower): the
      five feature banks ``{layer1..layer4, conv5}``, each average-pooled
      to ``(B, T_f, 7, 7, C)`` — the cache the coarse stream fuses;
    * ``extract_feat=True``: the head's output averaged over H and W
      (``task='loc'``, ``(B, T_f, 1, 1, C)``) or over T, H and W
      (``task='class'``, ``(B, 1, 1, 1, C)``);
    * otherwise f32 logits ``(B, T_f, n_classes)`` (``(B, 1, n_classes)``
      for ``task='class'``): the pooled features → ``fc1`` (1×1×1 conv to
      2048, no bias) → relu → dropout (in training, rate ``dropout_rate``,
      the mask drawn from the ``generator`` passed to :meth:`forward`) →
      ``fc2`` in the compute dtype.

    ``fc1``/``fc2`` exist only when the model returns logits, so a global
    tower's ``state_dict`` is the JAX pipeline's fine tower's.  With
    ``t_downsample`` the banks and the ``loc`` logits are at the stages'
    frames (T/2 … T/16, the head's T/16).

    ``channel_pad`` pads the mid and head widths (:class:`.x3d.X3DTrunk`)
    for the tensor-parallel tower; the banks and the pooled features are
    sliced back to the head's unpadded width, and ``fc1`` takes the padded
    one, as in the JAX package."""

    def __init__(self, version: str = "M", n_classes: int = 157,
                 task: str = "loc", dropout_rate: float = 0.5,
                 extract_feat: bool = False, global_tower: bool = True,
                 t_downsample: bool = False, remat: bool = False,
                 channel_pad: int = 1):
        super().__init__(version, t_downsample=t_downsample, remat=remat,
                         channel_pad=channel_pad)
        if task not in ("loc", "class"):
            raise ValueError(f"task must be 'loc' or 'class', got {task!r}")
        self.version, self.n_classes = version, n_classes
        self.task = task
        self.dropout_rate = dropout_rate
        self.extract_feat = extract_feat
        self.global_tower = global_tower
        # the head's unpadded width: the banks' and pooled features'
        self.head_planes = get_inplanes(version)[3][0]
        if not (global_tower or extract_feat):
            self.fc1 = nn.Conv3d(pad_width(self.head_planes, channel_pad),
                                 2048, 1, bias=False)
            self.fc2 = nn.Linear(2048, n_classes)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        """``generator`` draws the dropout mask in training (on x's device;
        needed when ``dropout_rate > 0``)."""
        x = self.stem(x)
        feats = {}
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            if self.global_tower:
                feats[f"layer{i + 1}"] = adaptive_avg_pool_spatial(x, TOWER_HW)
        x = self.head(x)
        return self.head_out(x, feats, generator)

    def head_out(self, x: torch.Tensor, feats: dict,
                 generator: torch.Generator | None = None):
        """The head's output ``x`` (padded width) → the banks (``feats``
        with ``conv5`` added), the pooled features or the logits."""
        if self.global_tower:
            feats["conv5"] = adaptive_avg_pool_spatial(
                x[..., :self.head_planes], TOWER_HW)
            return feats
        axes = (1, 2, 3) if self.task == "class" else (2, 3)
        x = torch.mean(x, dim=axes, keepdim=True)
        if self.extract_feat:
            return x[..., :self.head_planes]
        x = torch.relu(pointwise(x, self.fc1.weight))
        x = x.reshape(x.shape[0], x.shape[1], -1)
        x = dropout(x, self.dropout_rate if self.training else 0.0, generator)
        logits = nn.functional.linear(x, self.fc2.weight.to(x.dtype),
                                      self.fc2.bias.to(x.dtype))
        return logits.float()
