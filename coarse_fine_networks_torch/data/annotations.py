"""Charades annotation parsing and per-frame label rasterisation
(counterpart of ``coarse_fine_networks_tpu/data/annotations.py``).

Parses ``charades.json`` (``{vid: {subset, duration, actions: [[cls,
start_s, end_s]]}}``), rasterises the actions into a dense time-major
``(T, C)`` binary label matrix at ``fps = num_frames / duration``, skips
videos with fewer than ``min_frames`` frames on disk, and caches the table
in a compressed ``.npz`` beside the split file (or in ``cache_dir``).
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

DEFAULT_MIN_FRAMES = 2 * 80 + 2  # the reference's charades_fine.py:107

Entry = Tuple[str, np.ndarray, float, int]  # (vid, label (T, C), duration, nf)


def rasterize_annotations(actions, duration: float, num_frames: int,
                          num_classes: int = 157) -> np.ndarray:
    """Dense per-frame binary labels ``(num_frames, num_classes)``: frame
    ``fr`` is positive for class ``c`` iff ``start < fr/fps < end``."""
    label = np.zeros((num_frames, num_classes), np.float32)
    if duration <= 0 or num_frames <= 0:
        return label
    t = np.arange(num_frames) / (num_frames / duration)
    for cls, start, end in actions:
        label[(t > start) & (t < end), int(cls)] = 1.0
    return label


def _num_frames_on_disk(root: str, vid: str) -> int:
    d = os.path.join(root, vid)
    return len(os.listdir(d)) if os.path.isdir(d) else 0


def make_dataset(split_file: str, split: str, root: str,
                 num_classes: int = 157,
                 min_frames: int = DEFAULT_MIN_FRAMES,
                 use_cache: bool = True, frame_counts=None,
                 cache_dir: str | None = None) -> List[Entry]:
    """The per-video label table of ``split``, built once and cached.

    ``frame_counts`` (``{vid: num_frames}``) overrides the frame-directory
    listing; ``cache_dir`` moves the ``.npz`` cache away from the split
    file's directory."""
    base = (os.path.join(cache_dir, os.path.basename(split_file))
            if cache_dir else split_file)
    cache = f"{base[:-5]}_{split}_labels_torch.npz"
    if use_cache and os.path.exists(cache):
        with np.load(cache, allow_pickle=True) as z:  # written below
            return list(map(tuple, z["entries"]))

    with open(split_file) as f:
        data = json.load(f)
    entries: List[Entry] = []
    for vid, info in data.items():
        if info["subset"] != split:
            continue
        nf = (frame_counts.get(vid, 0) if frame_counts is not None
              else _num_frames_on_disk(root, vid))
        if nf < min_frames:
            continue
        label = rasterize_annotations(info["actions"], info["duration"], nf,
                                      num_classes)
        entries.append((vid, label, float(info["duration"]), nf))
    if use_cache:
        np.savez_compressed(cache, entries=np.asarray(entries, dtype=object))
    return entries
