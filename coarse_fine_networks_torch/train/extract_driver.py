"""Fine-feature extraction driver (counterpart of
``coarse_fine_networks_tpu/train/extract_driver.py``): one eval sweep over
whole videos (batch 1, every split asked for) with the global-tower
``FineNet``, writing the five per-level banks of each video to
``save_dir/<key>/<vid>.npy`` as float32 ``(T, 7, 7, C)``: the cache the
coarse stage reads."""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from ..data import (CenterCropScaled, CharadesDataset, Compose,
                    PrefetchLoader, collate_clips)
from ..models import FineNet, init_parameters
from ..models.fine import FEAT_KEYS
from ..models.layers import aggregate_sub_bn_stats
from ..models.surgery import set_bn_splits
from ..utils.hw import enable_compilation_cache
from .common import driver_device, load_pretrained, model_batch

log = logging.getLogger("cfn_torch")


def run(cfg, save_dir: str, fine_ckpt: Optional[str] = None,
        splits=("training", "testing")) -> int:
    """Extract every video of ``splits`` (whole videos either way); returns
    the number of videos.  ``fine_ckpt``: a reference ``.pt`` or the port's
    ``.ckpt`` of the fine stream (its logits head is ignored)."""
    enable_compilation_cache()
    device = driver_device(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    for k in FEAT_KEYS:
        os.makedirs(os.path.join(save_dir, k), exist_ok=True)
    val_t = Compose([CenterCropScaled(cfg.crop_size)])
    datasets = [CharadesDataset(
        cfg.anno, split, cfg.root, spatial_transform=val_t, task="loc",
        frames=cfg.frames, gamma_tau=cfg.gamma_tau, crops=1,
        extract_feat=True, min_frames=cfg.min_frames,
        num_classes=cfg.num_classes, crop_size=cfg.crop_size,
        pack_dir=cfg.pack_dir, device=cfg.device) for split in splits]

    model = FineNet(cfg.x3d_version, cfg.num_classes, task="loc",
                    global_tower=True)
    if cfg.base_bn_splits != 1:
        set_bn_splits(model, cfg.base_bn_splits)
    init_parameters(model, torch.Generator().manual_seed(0))
    if fine_ckpt:
        load_pretrained(model, fine_ckpt)
        log.info("loaded fine checkpoint %s", fine_ckpt)
    # the eval statistics from the split statistics a checkpoint stores;
    # without this the tower normalises with the init's eval statistics
    aggregate_sub_bn_stats(model)
    model = model.to(device).eval()

    count = nonfinite = 0
    with torch.no_grad():
        for ds in datasets:
            loader = PrefetchLoader(
                ds, 1, lambda b: collate_clips(b, cfg.pad_t_multiple, None),
                num_workers=cfg.num_workers, prefetch=cfg.prefetch)
            for batch in loader:
                feats = model(model_batch(batch, dtype, device)["clips"])
                # the padded frames' taps are not features: slice them off
                t_valid = int(batch["clip_mask"].sum())
                vid = batch["vids"][0]
                bad = False
                for k in FEAT_KEYS:
                    arr = feats[k][0, :t_valid].float().cpu().numpy()
                    bad = bad or not np.isfinite(arr).all()
                    np.save(os.path.join(save_dir, k, vid + ".npy"), arr)
                if bad:
                    if nonfinite == 0:
                        log.warning(
                            "non-finite features for %s: the fine "
                            "checkpoint's batch-norm statistics are "
                            "unusable (a barely-trained model's are still "
                            "the init's); coarse training on this bank will "
                            "saturate", vid)
                    nonfinite += 1
                count += 1
    if nonfinite:
        log.warning("extraction: %d/%d videos had non-finite features",
                    nonfinite, count)
    log.info("extraction done: %d videos → %s", count, save_dir)
    return count
