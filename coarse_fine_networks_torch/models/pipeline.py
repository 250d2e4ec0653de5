"""Joint Coarse-Fine inference (counterpart of
``coarse_fine_networks_tpu/models/pipeline.py``): the fine global tower
feeds the coarse stream in one module, and the two halves are exposed
separately (:meth:`CoarseFinePipeline.extract`, :meth:`.fuse`) so a serving
feature cache can skip the fine tower on repeat videos."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resample import linear_resize
from .coarse import CoarseNet
from .fine import FineNet
from .layers import init_parameters


class CoarseFinePipeline(nn.Module):
    """Fine tower → coarse stream, in eval mode on ``device``.

    Parameters stay float32; activations run in ``compute_dtype``.  With a
    ``generator`` every weight is drawn from it
    (:func:`.layers.init_parameters`); a checkpoint is loaded with
    ``load_state_dict`` (the reference's names under ``fine.``/``coarse.``).

    Inputs:
      clips:      ``(B, T, H, W, 3)`` coarse-stream frames.
      fine_clips: ``(B, T_f, H, W, 3)`` fine-stream frames.
      meta:       ``(B, 4)`` ``[start_f, frames, nf, stride]``.
    Returns per-frame class probabilities ``(B, label_len, n_classes)``."""

    def __init__(self, n_classes: int = 157, version: str = "M",
                 compute_dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fine = FineNet(version)
        self.coarse = CoarseNet(version, n_classes)
        if generator is not None:
            init_parameters(self, generator)
        self.to(torch.device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.coarse.fc2.weight.device

    def extract(self, fine_clips: torch.Tensor) -> dict[str, torch.Tensor]:
        """``(B, T_f, H, W, 3)`` → five f32 ``(B, T_f, 7, 7, C)`` banks."""
        x = fine_clips.to(self.device, self.compute_dtype)
        return {k: v.float() for k, v in self.fine(x).items()}

    def fuse(self, clips: torch.Tensor, feats: dict[str, torch.Tensor],
             feat_mask: torch.Tensor, meta: torch.Tensor,
             label_len: int | None = None) -> torch.Tensor:
        """Fusion graph + coarse stream over precomputed fine banks."""
        if label_len is None:
            label_len = 4 * clips.shape[1]
        dev = self.device
        feats = {k: v.to(dev) for k, v in feats.items()}
        logits = self.coarse(clips.to(dev, self.compute_dtype), feats,
                             feat_mask.to(dev, torch.float32), meta.to(dev))
        logits = linear_resize(logits, label_len, align_corners=False)
        return torch.sigmoid(logits.float())

    def forward(self, clips: torch.Tensor, fine_clips: torch.Tensor,
                meta: torch.Tensor, label_len: int | None = None,
                fine_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``fine_mask (B, T_f)`` marks the valid fine frames; serving pads
        each request to its bucket and masks the padding out of the fusion.
        """
        feats = self.extract(fine_clips)
        if fine_mask is None:
            fine_mask = torch.ones(fine_clips.shape[:2])
        return self.fuse(clips, feats, fine_mask, meta, label_len)
