"""Kinetics-style pretraining data: clip-level single-label samples
(counterpart of ``coarse_fine_networks_tpu/data/kinetics.py``).

A frame-directory corpus in the Charades layout (``root/<vid>/<vid>-%06d.jpg``)
with a JSON annotation ``{vid: {"label": int, "subset": "training" |
"validation", "num_frames": int}}`` trains the fine stream in
``task='class'`` mode (:mod:`..train.kinetics_driver`); the checkpoint it
saves is the ``kinetics_ckpt`` of the detection drivers.

Frames are decoded with Pillow; ``decode_backend="native"`` raises, as
:class:`.dataset.CharadesDataset`'s does.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from . import bufpool
from .dataset import _NATIVE, load_clip_frames
from .transforms import RandomHorizontalFlip


class KineticsDataset:
    """Clip sampler for single-label video classification.

    Training draws a random window of ``frames`` frames at stride
    ``gamma_tau`` (its start from ``random.Random(seed)``); validation takes
    the centre window.  Samples are ``{"clips" (1, T, H, W, 3) uint8,
    "label", "vid", "flip"}``; :func:`collate_kinetics` stacks them.
    ``frames`` is the clip's true length (the long cycle sets it per
    phase)."""

    def __init__(self, anno: str, split: str, root: str,
                 spatial_transform=None, frames: int = 16,
                 gamma_tau: int = 5, min_frames: Optional[int] = None,
                 crop_size: int = 224, decode_backend: str = "auto",
                 seed: int = 0):
        if decode_backend not in ("auto", "pil"):
            raise NotImplementedError(f"decode_backend={decode_backend!r}: "
                                      f"{_NATIVE}")
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
        imgs = load_clip_frames(self.root, vid, start, window,
                                self.gamma_tau)
        flip = False
        if self.spatial_transform is not None:
            self.spatial_transform.randomize_parameters(self.crop_size)
            for t in getattr(self.spatial_transform, "transforms",
                             [self.spatial_transform]):
                if isinstance(t, RandomHorizontalFlip) and t.deferred:
                    flip = t.flipped
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
    n, h, w = batch[0]["clips"].shape[0], *batch[0]["clips"].shape[2:4]
    clips = bufpool.borrow((len(batch), n, max_t, h, w, 3), np.uint8)
    clip_mask = bufpool.borrow((len(batch), max_t), np.float32, zero=True)
    for i, b in enumerate(batch):
        t = b["clips"].shape[1]
        clips[i, :, :t] = b["clips"]
        clips[i, :, t:] = 0
        clip_mask[i, :t] = 1.0
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
