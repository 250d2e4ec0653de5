"""Temporal transforms (re-design of ``transforms/temporal_transforms.py``;
counterpart of ``coarse_fine_networks_tpu/data/temporal_transforms.py``).

The reference imports these in every driver but the datasets do temporal
cropping internally (SURVEY.md §2 #20); they are provided for API parity and
standalone use.  Each maps a list of frame indices to a new list.
"""

from __future__ import annotations

import random
from typing import List, Optional


def _loop_pad(indices: List[int], size: int) -> List[int]:
    """Repeat indices cyclically until ``size`` (the reference's loop-padding
    idiom, temporal_transforms.py:12-18)."""
    out = list(indices)
    i = 0
    while out and len(out) < size:
        out.append(out[i % len(indices)])
        i += 1
    return out


class LoopPadding:
    """Loop indices until ``size`` (temporal_transforms.py:6-19)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, frame_indices: List[int]) -> List[int]:
        return _loop_pad(frame_indices, self.size)


class TemporalBeginCrop:
    """First ``size`` indices, loop-padded (temporal_transforms.py:22-43)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, frame_indices: List[int]) -> List[int]:
        return _loop_pad(frame_indices[: self.size], self.size)


class TemporalCenterCrop:
    """Centered ``size`` window, loop-padded (temporal_transforms.py:46-78)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, frame_indices: List[int]) -> List[int]:
        center = len(frame_indices) // 2
        begin = max(0, center - (self.size // 2))
        end = min(begin + self.size, len(frame_indices))
        return _loop_pad(frame_indices[begin:end], self.size)


class TemporalRandomCrop:
    """Random strided window + loop padding, with the multigrid dynamic-size
    hook (temporal_transforms.py:81-119; ``size`` may be overridden at
    randomise time like ``MultiScaleRandomCropMultigrid``)."""

    def __init__(self, size: int, gamma_tau: int = 1, t_stride: int = 1):
        self.size = size
        self.init_size = size
        self.gamma_tau = gamma_tau
        self.t_stride = t_stride

    def randomize_parameters(self, size: Optional[int] = None, index: int = 0):
        if size:
            self.size = size

    def __call__(self, frame_indices: List[int]) -> List[int]:
        span = self.size * self.t_stride * self.gamma_tau
        rand_end = max(0, len(frame_indices) - span - 1)
        begin = random.randint(0, rand_end)
        end = min(begin + span, len(frame_indices))
        window = frame_indices[begin : end : self.t_stride * self.gamma_tau]
        return _loop_pad(window, self.size)
