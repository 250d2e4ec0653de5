"""Adaptive spatial pooling on channels-last ``(B, T, H, W, C)`` tensors.

Counterpart of ``coarse_fine_networks_tpu/ops/pools.py``.  PyTorch's adaptive
pools use the window rule the JAX package reimplements
(``[floor(i·in/out), ceil((i+1)·in/out))``), so they are called directly; the
tensor is viewed as ``(B·T, C, H, W)`` around the call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _spatial(x: torch.Tensor, out_hw: int, pool) -> torch.Tensor:
    b, t, h, w, c = x.shape
    if h == out_hw and w == out_hw:
        return x
    y = pool(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2), out_hw)
    return y.permute(0, 2, 3, 1).reshape(b, t, out_hw, out_hw, c)


def adaptive_avg_pool_spatial(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """``F.adaptive_avg_pool3d(x, (None, out, out))`` on ``(B, T, H, W, C)``
    (the fine global-tower taps)."""
    return _spatial(x, out_hw, F.adaptive_avg_pool2d)


def adaptive_max_pool_spatial(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """``F.adaptive_max_pool2d`` over the H, W axes of ``(B, T, H, W, C)``;
    for divisible upscales this is nearest-neighbour replication."""
    return _spatial(x, out_hw, F.adaptive_max_pool2d)


def spatial_replicate(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """Nearest-neighbour upscale of H, W by an integer factor (adaptive
    max-pool upsampling for a non-divisible size)."""
    b, t, h, w, c = x.shape
    if out_hw % h != 0:
        return adaptive_max_pool_spatial(x, out_hw)
    f = out_hw // h
    x = x[:, :, :, None, :, None, :].expand(b, t, h, f, w, f, c)
    return x.reshape(b, t, out_hw, out_hw, c)


def temporal_pool(x: torch.Tensor, kind: str, window: int = 4) -> torch.Tensor:
    """``CoarseNet``'s fixed temporal pools over T of ``(B, T, H, W, C)``:
    ``avg`` and ``max`` over windows of ``window`` frames at stride
    ``window``, VALID (flax's ``nn.avg_pool`` / ``nn.max_pool`` with
    ``(window, 1, 1)``: ⌊T/window⌋ frames, the average in x's dtype), or
    ``stride``, every ``window``-th frame (``x[:, ::window]``: ⌈T/window⌉
    frames)."""
    if kind == "stride":
        return x[:, ::window]
    b, t, h, w, c = x.shape
    n = t // window
    xw = x[:, :n * window].reshape(b, n, window, h, w, c)
    if kind == "avg":
        return torch.sum(xw, dim=2) / window
    if kind == "max":
        return torch.amax(xw, dim=2)
    raise ValueError(f"temporal pool must be avg, max or stride, got {kind!r}")
