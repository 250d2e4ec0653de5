"""Fine-stream training driver (counterpart of
``coarse_fine_networks_tpu/train/fine_driver.py``): so far the two helpers
the coarse driver shares, the clip transforms and the per-frame AP
accumulation.  The loop itself (the long cycle's loaders, multi-crop fine
eval, checkpoints) is the next slice of the port; its train step, long
cycle and device batch are in :mod:`.steps`, :mod:`.multigrid` and
:mod:`.common`."""

from __future__ import annotations

import numpy as np

from ..data.transforms import (CenterCropScaled, Compose,
                               MultiScaleRandomCropMultigrid,
                               RandomHorizontalFlip)
from ..metrics import APMeter


def build_transforms(cfg):
    """Train: ``MultiScaleRandomCropMultigrid`` + a deferred horizontal
    flip; val: ``CenterCropScaled``.  ToTensor and Normalize run on the
    device."""
    train_t = Compose([
        MultiScaleRandomCropMultigrid(list(cfg.scales), cfg.crop_size),
        RandomHorizontalFlip(deferred=True),
    ])
    val_t = Compose([CenterCropScaled(cfg.crop_size)])
    return train_t, val_t


def _add_ap(apm: APMeter, probs: np.ndarray, labels: np.ndarray,
            masks: np.ndarray) -> None:
    """Accumulate AP over each sample's valid frames."""
    valid = masks.sum(axis=1).astype(int)
    for b in range(labels.shape[0]):
        apm.add(probs[b, :valid[b]], labels[b, :valid[b]])


def _add_ap_batches(apm: APMeter, probs: np.ndarray, host_batches) -> None:
    """Accumulate AP for one train step (host probabilities); with gradient
    accumulation ``probs`` has a leading micro-step axis matching
    ``host_batches``."""
    if len(host_batches) > 1:
        for i, hb in enumerate(host_batches):
            _add_ap(apm, probs[i], hb["labels"], hb["masks"])
    else:
        _add_ap(apm, probs, host_batches[0]["labels"],
                host_batches[0]["masks"])
