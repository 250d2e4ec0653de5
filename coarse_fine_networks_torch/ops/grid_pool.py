"""Grid-pool CDF construction (counterpart of
``coarse_fine_networks_tpu/ops/grid_pool.py``)."""

from __future__ import annotations

import torch


def cdf_knots(scores: torch.Tensor) -> torch.Tensor:
    """Region scores ``(B, T/r)`` → monotone knots ``(B, T/r + 1)`` in
    ``[0, 1]`` with a leading zero: the inverse-transform-sampling CDF of
    ``1 - sigmoid(scores / 2)``."""
    w = 1.0 - torch.sigmoid(scores * 0.5)
    w = w / (torch.sum(w, dim=1, keepdim=True) + 1e-16)
    cdf = torch.cumsum(w, dim=1)
    return torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=1)
