"""1-D temporal resampling as small dense "hat matrix" products.

Counterpart of ``coarse_fine_networks_tpu/ops/resample.py``: learned-grid
pooling, inverse-CDF evaluation and ``F.interpolate(mode='linear')`` are all
linear maps along time, written as a weight matrix ``W[t, k]`` contracted with
the features.  Out-of-range taps get zero weight (``grid_sample``'s zero
padding).
"""

from __future__ import annotations

import torch

# torch.finfo(torch.float32).eps: the interp1d slope denominator's epsilon
_F32_EPS = float(torch.finfo(torch.float32).eps)


def hat_matrix(positions: torch.Tensor, length: int) -> torch.Tensor:
    """``(..., K)`` positions in source-index units → ``(..., T, K)`` linear
    interpolation weights with zero padding outside ``[0, T-1]``.

    The gradient with respect to the positions follows JAX's conventions
    where the hat has a kink, as the learned Grid Pool knots can sit there:
    ``|r|`` has slope +1 at ``r = 0`` and ``max(d, 0)`` splits its gradient
    in half at ``d = 0``."""
    t = torch.arange(length, dtype=positions.dtype, device=positions.device)
    r = positions[..., None, :] - t[:, None]
    d = 1.0 - torch.where(r >= 0, r, -r)
    return torch.maximum(d, d.new_zeros(()))


def temporal_resample(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Resample ``x (B, T, ...)`` along time at per-batch ``positions (B, K)``
    → ``(B, K, ...)``."""
    b, t = x.shape[0], x.shape[1]
    w = hat_matrix(positions, t)  # (B, T, K)
    out = torch.bmm(w.transpose(1, 2), x.reshape(b, t, -1))
    return out.reshape((b, positions.shape[-1]) + tuple(x.shape[2:]))


def _resize_positions(in_len: int, out_len: int, align_corners: bool,
                      dtype: torch.dtype, device) -> torch.Tensor:
    """Source positions used by ``F.interpolate(mode='linear')``."""
    j = torch.arange(out_len, dtype=dtype, device=device)
    if align_corners:
        if out_len == 1:
            return torch.zeros((1,), dtype=dtype, device=device)
        return j * ((in_len - 1) / (out_len - 1))
    pos = (j + 0.5) * (in_len / out_len) - 0.5
    return torch.clamp(pos, 0.0, float(in_len - 1))  # constants: no gradient


def linear_resize(x: torch.Tensor, out_len: int,
                  align_corners: bool = True) -> torch.Tensor:
    """``F.interpolate(x, out_len, mode='linear')`` along axis 1 of
    ``(B, T, ...)``."""
    b, t = x.shape[0], x.shape[1]
    pos = _resize_positions(t, out_len, align_corners, x.dtype, x.device)
    w = hat_matrix(pos, t)  # (T, K)
    out = torch.matmul(w.t(), x.reshape(b, t, -1))
    return out.reshape((b, out_len) + tuple(x.shape[2:]))


def inverse_cdf(knots: torch.Tensor, num_out: int | None = None) -> torch.Tensor:
    """Invert batched monotone CDF knots ``(B, K)`` (sampled at ``i/(K-1)``)
    at ``num_out`` uniform points, by linear interpolation:
    ``searchsorted(side='left')``, then ``-1``, then a clip to a valid
    segment."""
    b, k = knots.shape
    if num_out is None:
        num_out = k
    u = torch.linspace(0.0, 1.0, num_out, dtype=knots.dtype,
                       device=knots.device)
    ind = torch.searchsorted(knots.contiguous(),
                             u.expand(b, num_out).contiguous(), side="left")
    ind = torch.clamp(ind - 1, 0, k - 2)
    x0 = torch.gather(knots, 1, ind)
    x1 = torch.gather(knots, 1, ind + 1)
    y0 = ind.to(knots.dtype) / (k - 1)
    y1 = (ind + 1).to(knots.dtype) / (k - 1)
    slope = (y1 - y0) / (_F32_EPS + (x1 - x0))
    return y0 + slope * (u[None, :] - x0)


def interp1d(x: torch.Tensor, y: torch.Tensor, xnew: torch.Tensor) -> torch.Tensor:
    """Batched linear interpolation of ``(x, y)`` samples ``(B, N)`` at
    ``xnew (B, P)``, extrapolating linearly from the edge segments."""
    n = x.shape[1]
    ind = torch.searchsorted(x.contiguous(), xnew.contiguous(), side="left")
    ind = torch.clamp(ind - 1, 0, n - 2)
    x0 = torch.gather(x, 1, ind)
    x1 = torch.gather(x, 1, ind + 1)
    y0 = torch.gather(y, 1, ind)
    y1 = torch.gather(y, 1, ind + 1)
    slope = (y1 - y0) / (_F32_EPS + (x1 - x0))
    return y0 + slope * (xnew - x0)
