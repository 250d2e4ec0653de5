"""Streaming per-class average precision (counterpart of
``coarse_fine_networks_tpu/metrics/ap.py``): the reference ``APMeter``'s
definition (per class, scores sorted descending, the precision averaged at
each positive's rank) as one vectorised numpy pass."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class APMeter:
    """Accumulate ``(N, K)`` score/target chunks; :meth:`value` → per-class
    AP ``(K,)``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._scores: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []
        self._weights: List[np.ndarray] = []

    def add(self, output, target, weight: Optional[np.ndarray] = None
            ) -> None:
        output = np.asarray(output, np.float32)
        target = np.asarray(target, np.float32)
        if output.ndim == 1:
            output = output[:, None]
        if target.ndim == 1:
            target = target[:, None]
        if output.shape != target.shape:
            raise ValueError(f"scores {output.shape} != targets "
                             f"{target.shape}")
        if not ((target == 0) | (target == 1)).all():
            raise ValueError("targets must be binary")
        if self._scores and output.shape[1] != self._scores[0].shape[1]:
            raise ValueError(f"{output.shape[1]} classes, earlier chunks "
                             f"had {self._scores[0].shape[1]}")
        self._scores.append(output)
        self._targets.append(target)
        if weight is not None:
            self._weights.append(np.asarray(weight, np.float32).reshape(-1))

    def value(self) -> np.ndarray:
        """Per-class AP (an empty array before any :meth:`add`)."""
        if not self._scores:
            return np.zeros(0, np.float32)
        scores = np.concatenate(self._scores, axis=0)
        targets = np.concatenate(self._targets, axis=0)
        n, k = scores.shape
        order = np.argsort(-scores, axis=0, kind="stable")
        truth = np.take_along_axis(targets, order, axis=0)
        if self._weights:
            w = np.broadcast_to(np.concatenate(self._weights)[:, None],
                                (n, k))
            w = np.take_along_axis(w, order, axis=0)
            tp = np.cumsum(truth * w, axis=0)
            rank = np.cumsum(w, axis=0)
        else:
            tp = np.cumsum(truth, axis=0)
            rank = np.arange(1, n + 1, dtype=np.float32)[:, None]
        precision = tp / rank
        pos = truth.sum(axis=0)
        ap = (precision * truth).sum(axis=0) / np.maximum(pos, 1)
        return ap.astype(np.float32)

    def mean(self) -> float:
        v = self.value()
        return float(v.mean()) if v.size else 0.0
