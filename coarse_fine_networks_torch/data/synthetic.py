"""Synthetic mini-Charades: a generated frame-JPEG tree and annotation JSON
for end-to-end runs without the dataset (counterpart of
``coarse_fine_networks_tpu/data/synthetic.py``; for one seed it writes the
same JSON and the same JPEG bytes)."""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image


def _stamp_class_cue(img: np.ndarray, cls: int, hw: int) -> np.ndarray:
    """A saturated square at a class-specific slot of a 3×3 grid inside the
    central 2/3 of the frame, so the labels are learnable from pixels and
    survive the centre and random crops."""
    g = 3
    row, col = divmod((cls * 7) % (g * g), g)
    margin = hw // 6
    span = hw - 2 * margin
    sz = max(4, hw // 8)
    step = max(1, (span - sz) // max(g - 1, 1))
    y0 = margin + row * step
    x0 = margin + col * step
    color = np.array([(cls * 67 + 96) % 256, (cls * 131 + 32) % 256,
                      (cls * 29 + 160) % 256], np.uint8)
    img = img.copy()
    img[y0:y0 + sz, x0:x0 + sz] = color
    return img


def generate_mini_charades(root: str, num_videos: int = 4,
                           num_frames: int = 48, hw: int = 64,
                           num_classes: int = 157,
                           train_fraction: float = 0.5,
                           seed: int = 0) -> str:
    """Write ``root/frames/<vid>/<vid>-%06d.jpg`` and
    ``root/annotations.json``; return the annotation path.  The first
    ``train_fraction`` of the videos are ``training``, the rest
    ``testing``."""
    rng = np.random.RandomState(seed)
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    anno = {}
    n_train = max(1, int(num_videos * train_fraction))
    for v in range(num_videos):
        vid = f"SYN{v:03d}"
        vdir = os.path.join(frames_dir, vid)
        os.makedirs(vdir, exist_ok=True)
        base = rng.randint(0, 200, size=(hw, hw, 3)).astype(np.uint8)
        duration = num_frames / 24.0
        fps = num_frames / duration
        actions = []
        for _ in range(rng.randint(1, 4)):
            cls = int(rng.randint(0, num_classes))
            s = float(rng.uniform(0, duration * 0.7))
            e = float(min(duration, s + rng.uniform(0.2, duration * 0.5)))
            actions.append([cls, s, e])
        for fr in range(1, num_frames + 1):
            img = np.clip(base.astype(np.int32) + (fr * 3) % 55, 0,
                          255).astype(np.uint8)
            t_sec = (fr - 1) / fps
            for cls, s, e in actions:
                if s <= t_sec < e:
                    img = _stamp_class_cue(img, int(cls), hw)
            Image.fromarray(img).save(
                os.path.join(vdir, f"{vid}-{fr:06d}.jpg"), quality=70)
        anno[vid] = {"subset": "training" if v < n_train else "testing",
                     "duration": duration, "actions": actions}
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump(anno, f)
    return path
