"""Multi-THUMOS support (the reference's second benchmark, README.md:21;
counterpart of ``coarse_fine_networks_tpu/data/multithumos.py``).

The reference repo ships no Multi-THUMOS loader; its README reports results on
the dataset.  Multi-THUMOS annotations come as per-class text files
(``<ClassName>.txt`` with ``video_id start_sec end_sec`` rows) plus a
``class_list.txt`` (``id name`` per line).  This adapter converts them to the
Charades-style annotation json consumed by :class:`.dataset.CharadesDataset`
(``{vid: {subset, duration, actions: [[cls, start, end]]}}``), so the whole
pipeline — fine training, extraction, coarse training, localisation CSV —
works unchanged at ``num_classes=65``.

THUMOS convention: ``video_validation_*`` videos train, ``video_test_*``
videos evaluate.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

NUM_CLASSES = 65


def load_class_list(path: str) -> Dict[str, int]:
    """``class_list.txt`` → {name: zero-based index}."""
    mapping = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                mapping[parts[1]] = int(parts[0]) - 1  # THUMOS ids are 1-based
    return mapping


def convert_annotations(
    anno_dir: str,
    class_list: str,
    frames_root: str,
    out_json: str,
    fps: float = 30.0,
    durations: Optional[Dict[str, float]] = None,
) -> str:
    """Build the framework annotation json from Multi-THUMOS per-class files.

    ``duration`` comes from ``durations`` when given, else from the frame
    count on disk at ``fps``.
    """
    classes = load_class_list(class_list)
    videos: Dict[str, dict] = {}

    def ensure(vid: str) -> Optional[dict]:
        if vid in videos:
            return videos[vid]
        if durations and vid in durations:
            dur = durations[vid]
        else:
            vdir = os.path.join(frames_root, vid)
            if not os.path.isdir(vdir):
                return None
            dur = len(os.listdir(vdir)) / fps
        subset = "training" if "validation" in vid else "testing"
        videos[vid] = {"subset": subset, "duration": dur, "actions": []}
        return videos[vid]

    for name, idx in classes.items():
        path = os.path.join(anno_dir, f"{name}.txt")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                vid, start, end = parts[0], float(parts[1]), float(parts[2])
                entry = ensure(vid)
                if entry is not None:
                    entry["actions"].append([idx, start, end])

    with open(out_json, "w") as f:
        json.dump(videos, f)
    return out_json
