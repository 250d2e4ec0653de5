"""``Charades_v1_localize`` prediction CSV (counterpart of
``coarse_fine_networks_tpu/metrics/localize.py``): per video the per-frame
probabilities subsampled to 25 frames, one row ``(vid, timestamp, <C
scores, space-separated>)`` each."""

from __future__ import annotations

import csv
from typing import Optional

import numpy as np


def subsample_25(probs_tc: np.ndarray, valid_t: int,
                 labels_tc: Optional[np.ndarray] = None):
    """The 25-frame slice ``x[:valid_t][1::int(valid_t/25)][:25]``,
    time-major (``train_coarse_fineFEAT.py:251-253``); with ``labels_tc``
    the labels' slice too."""
    sc = max(int(valid_t / 25.0), 1)
    p = probs_tc[:valid_t][1::sc][:25]
    if labels_tc is None:
        return p
    return p, labels_tc[:valid_t][1::sc][:25]


class LocalizeCSVWriter:
    """Write prediction rows in the official localise format."""

    def __init__(self, path: str):
        self._file = open(path, "w", newline="\n")
        self._writer = csv.writer(self._file)

    def add_video(self, vid: str, probs_tc: np.ndarray,
                  duration: float) -> None:
        """``probs_tc``: ``(25, C)`` subsampled probabilities (host
        floats)."""
        for i in range(probs_tc.shape[0]):
            scores = " ".join(str(float(s)) for s in probs_tc[i])
            self._writer.writerow([vid, 1 + i * duration / 25.0, scores])

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
