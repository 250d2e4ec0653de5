"""Kinetics-style pretraining data: clip-level single-label samples
(counterpart of ``coarse_fine_networks_tpu/data/kinetics.py``).

A frame-directory corpus in the Charades layout (``root/<vid>/<vid>-%06d.jpg``)
with a JSON annotation ``{vid: {"label": int, "subset": "training" |
"validation", "num_frames": int}}`` trains the fine stream in
``task='class'`` mode (:mod:`..train.kinetics_driver`); the checkpoint it
saves is the ``kinetics_ckpt`` of the detection drivers.

Frames are decoded natively where the spatial pipeline allows
(:mod:`.native`), else with Pillow, as :class:`.dataset.CharadesDataset`
decodes them; the JAX Kinetics dataset reads no packs, and neither does
this one.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from . import bufpool, native
from .dataset import (deferred_flip, load_clip_frames, native_transforms,
                      pad_clips)


class KineticsDataset:
    """Clip sampler for single-label video classification.

    Training draws a random window of ``frames`` frames at stride
    ``gamma_tau`` (its start from ``random.Random(seed)``); validation takes
    the centre window.  Samples are ``{"clips" (1, T, H, W, 3) uint8,
    "label", "vid", "flip"}``; :func:`collate_kinetics` stacks them.
    ``frames`` is the clip's true length (the long cycle sets it per
    phase).  ``decode_backend`` and ``device`` as
    :class:`.dataset.CharadesDataset`'s."""

    def __init__(self, anno: str, split: str, root: str,
                 spatial_transform=None, frames: int = 16,
                 gamma_tau: int = 5, min_frames: Optional[int] = None,
                 crop_size: int = 224, decode_backend: str = "auto",
                 seed: int = 0, device: str = "cuda"):
        with open(anno) as f:
            raw = json.load(f)
        self.data: List[tuple] = []
        for vid, info in sorted(raw.items()):
            if info.get("subset", "training") != split:
                continue
            nf = info.get("num_frames", 0)
            if min_frames and nf < min_frames:
                continue
            self.data.append((vid, int(info["label"]), nf))
        self.root = root
        self.split = split
        self.frames = frames
        self.gamma_tau = gamma_tau
        self.spatial_transform = spatial_transform
        self.crop_size = crop_size
        self.native_crop, self.native_train = native_transforms(
            spatial_transform, decode_backend)
        self.device = native.resolve_device(device)
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.data)

    def num_frames(self, index: int) -> int:
        return self.data[index][2]

    def __getitem__(self, index: int) -> Dict:
        vid, label, nf = self.data[index]
        window = self.frames * self.gamma_tau
        if self.split == "training":
            start = self.rng.randint(1, max(1, nf - window))
        else:
            start = max(1, (nf - window) // 2)
        flip = False
        if self.native_crop is not None or self.native_train is not None:
            paths = []
            for i in range(start, start + window, self.gamma_tau):
                p = os.path.join(self.root, vid, f"{vid}-{i:06d}.jpg")
                if not os.path.exists(p):
                    break
                paths.append(p)
            if self.native_train is not None:
                self.spatial_transform.randomize_parameters(self.crop_size)
                mt = self.native_train
                flip = deferred_flip(self.spatial_transform)
                arr = native.decode_batch_random_crop(
                    paths, mt.size, mt.scale, mt.tl_x, mt.tl_y,
                    device=self.device)
            else:
                arr = native.decode_batch(paths, self.native_crop,
                                          device=self.device)
        else:
            imgs = load_clip_frames(self.root, vid, start, window,
                                    self.gamma_tau)
            if self.spatial_transform is not None:
                self.spatial_transform.randomize_parameters(self.crop_size)
                flip = deferred_flip(self.spatial_transform)
                imgs = [self.spatial_transform(img) for img in imgs]
            arr = np.stack([np.asarray(im, np.uint8) for im in imgs], axis=0)
        return {"clips": arr[None], "label": label, "vid": vid, "flip": flip}


def collate_kinetics(batch: List[Dict], pad_t_multiple: Optional[int] = None
                     ) -> Dict:
    """Stack the clips into pooled buffers, zero-padded to the batch's
    longest clip rounded up to ``pad_t_multiple``, with ``clip_mask (B, T)``
    of the valid frames and the int32 ``labels (B,)``."""
    max_t = max(b["clips"].shape[1] for b in batch)
    if pad_t_multiple:
        max_t = -(-max_t // pad_t_multiple) * pad_t_multiple
    clips = pad_clips(batch, max_t)
    clip_mask = bufpool.borrow((len(batch), max_t), np.float32, zero=True)
    for i, b in enumerate(batch):
        clip_mask[i, :b["clips"].shape[1]] = 1.0
    return {"clips": clips, "clip_mask": clip_mask,
            "labels": np.asarray([b["label"] for b in batch], np.int32),
            "flip": np.asarray([b["flip"] for b in batch]),
            "vids": [b["vid"] for b in batch]}


def generate_mini_kinetics(root: str, num_videos: int = 8,
                           num_frames: int = 40, hw: int = 64,
                           num_classes: int = 10, seed: int = 0) -> str:
    """A synthetic Kinetics-style corpus (every fourth video in
    ``validation``); returns the annotation path.  For one seed it writes
    the JAX package's JSON and JPEG bytes."""
    rng = np.random.RandomState(seed)
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    anno = {}
    for v in range(num_videos):
        vid = f"KIN{v:03d}"
        vdir = os.path.join(frames_dir, vid)
        os.makedirs(vdir, exist_ok=True)
        base = rng.randint(0, 200, size=(hw, hw, 3)).astype(np.uint8)
        for fr in range(1, num_frames + 1):
            img = np.clip(base + rng.randint(-20, 20, size=base.shape), 0,
                          255).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(vdir, f"{vid}-{fr:06d}.jpg"), quality=85)
        anno[vid] = {"label": int(v % num_classes),
                     "subset": "training" if v % 4 else "validation",
                     "num_frames": num_frames}
    path = os.path.join(root, "kinetics.json")
    with open(path, "w") as f:
        json.dump(anno, f)
    return path
