"""``Charades_v1_localize`` evaluation (counterpart of
``coarse_fine_networks_tpu/metrics/charades_eval.py``): parse a submission
CSV, sample the ground truth at each submitted timestamp (25 canonical ones
for a video missing from the submission) and pool the per-class AP over
every (video, frame) pair."""

from __future__ import annotations

import csv
from typing import Dict, List, Mapping, Tuple

import numpy as np

from .ap import APMeter


def load_submission(path: str) -> Dict[str, List[Tuple[float, np.ndarray]]]:
    """Submission CSV → ``{vid: [(timestamp_s, scores (C,)), ...]}``."""
    out: Dict[str, List[Tuple[float, np.ndarray]]] = {}
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) < 3:
                continue
            arr = np.asarray([float(s) for s in row[2].split()], np.float32)
            out.setdefault(row[0], []).append((float(row[1]), arr))
    return out


def frame_labels_at(annotation: Mapping, timestamp: float,
                    num_classes: int) -> np.ndarray:
    """Binary labels at one timestamp: a class is active iff
    ``start < t < end``."""
    y = np.zeros(num_classes, np.float32)
    for cls, start, end in annotation["actions"]:
        if start < timestamp < end:
            y[int(cls)] = 1.0
    return y


def canonical_timestamps(duration: float, n: int = 25) -> List[float]:
    """The CSV's 25 timestamps of a video: ``1 + i·duration/25``."""
    return [1.0 + i * duration / float(n) for i in range(n)]


def evaluate_localization(submission_path: str,
                          annotations: Mapping[str, Mapping],
                          num_classes: int = 157,
                          subset: str | None = "testing",
                          count_missing: bool = True
                          ) -> Tuple[float, np.ndarray]:
    """Per-frame mAP of a submission against ``annotations`` (the
    charades.json dict), returned as ``(mAP, per-class AP (C,))``.

    ``subset``: evaluate only annotations of that subset (or with none);
    ``count_missing``: score a video missing from the submission as zeros at
    its canonical timestamps, as the official script does."""
    sub = load_submission(submission_path)
    apm = APMeter()
    for vid, ann in annotations.items():
        vsub = ann.get("subset")
        if subset is not None and vsub is not None and vsub != subset:
            continue
        rows = sub.get(vid)
        if rows is None:
            if not count_missing:
                continue
            ts = canonical_timestamps(float(ann.get("duration", 0.0)))
            scores = np.zeros((len(ts), num_classes), np.float32)
        else:
            ts = [r[0] for r in rows]
            scores = np.stack([r[1] for r in rows])
        apm.add(scores, np.stack([frame_labels_at(ann, t, num_classes)
                                  for t in ts]))
    ap = apm.value()
    return (float(ap.mean()) if ap.size else 0.0), ap
