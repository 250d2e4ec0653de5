"""Batch preparation shared by the drivers (counterpart of
``prepare_clips`` and ``model_batch`` in
``coarse_fine_networks_tpu/train/common.py``): the host's uint8 batch
becomes the device batch dict the train and eval steps take."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..data.transforms import CHARADES_MEAN, CHARADES_STD, device_normalize


def _on(v, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(v).to(device=device, dtype=dtype)


def prepare_clips(batch: Dict[str, Any], mean=CHARADES_MEAN,
                  std=CHARADES_STD, dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """uint8 ``clips (B, N, T, H, W, 3)`` with ``flip (B,)`` and
    ``clip_mask (B, T)`` → normalised clips ``(B·N, T, H, W, 3)`` in
    ``dtype`` on ``device``.

    The N crops of a sample fold into the batch, each with its sample's
    flip (training has N = 1, so this squeezes the crops axis); padded
    frames are zeroed after the normalisation, as the reference zero-pads
    normalised tensors."""
    clips = _on(batch["clips"], device)
    b, n = clips.shape[:2]
    clips = clips.reshape((b * n,) + tuple(clips.shape[2:]))
    flip = torch.repeat_interleave(_on(batch["flip"], device, torch.bool), n)
    cm = torch.repeat_interleave(_on(batch["clip_mask"], device), n, dim=0)
    x = device_normalize(clips, flip, mean, std, out_dtype=dtype)
    return x * cm.to(dtype)[:, :, None, None, None]


def model_batch(batch: Dict[str, Any], dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda") -> Dict[str, Any]:
    """The device batch dict of the train and eval steps: ``clips`` from
    :func:`prepare_clips` (``dtype``: the model's compute dtype), ``labels``
    and ``masks``, and for the coarse stream ``feats``, ``feat_mask`` and
    ``meta``."""
    out = {"clips": prepare_clips(batch, dtype=dtype, device=device),
           "labels": _on(batch["labels"], device),
           "masks": _on(batch["masks"], device)}
    if "feats" in batch:
        out["feats"] = {k: _on(v, device) for k, v in batch["feats"].items()}
        out["feat_mask"] = _on(batch["feat_mask"], device)
        out["meta"] = _on(batch["meta"], device)
    return out
