"""Fine-stream X3D global tower (counterpart of
``coarse_fine_networks_tpu/models/fine.py`` with ``global_tower=True``).

The per-frame logits, ``extract_feat`` and ``t_downsample`` modes of the JAX
``FineNet`` belong to fine-stream training and are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.pools import adaptive_avg_pool_spatial
from .x3d import X3DTrunk

# Spatial size of the global-tower feature taps.
TOWER_HW = 7
FEAT_KEYS = ("layer1", "layer2", "layer3", "layer4", "conv5")


class FineNet(X3DTrunk):
    """X3D fine stream as a global tower: ``(B, T_f, H, W, 3)`` → the five
    feature banks ``{layer1..layer4, conv5}``, each average-pooled to
    ``(B, T_f, 7, 7, C)`` — the cache the coarse stream fuses."""

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.stem(x)
        feats = {}
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            feats[f"layer{i + 1}"] = adaptive_avg_pool_spatial(x, TOWER_HW)
        feats["conv5"] = adaptive_avg_pool_spatial(self.head(x), TOWER_HW)
        return feats
