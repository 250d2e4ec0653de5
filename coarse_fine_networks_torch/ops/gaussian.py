"""Gaussian temporal alignment between fine-stream frames and coarse
locations (counterpart of ``coarse_fine_networks_tpu/ops/gaussian.py``)."""

from __future__ import annotations

import torch


def gaussian_alignment(meta: torch.Tensor, feat_mask: torch.Tensor,
                       knots: torch.Tensor | None, t_in: int,
                       coarse_len: int | None = None, ratio: float = 1.0,
                       crops: int = 1) -> torch.Tensor:
    """Alignment matrix ``(B·crops, T_fine, K)``.

    Args:
      meta: ``(B, 4)`` ``[start_f, frames, nf, stride]`` per sample.
      feat_mask: ``(B, T_fine)`` validity of the cached fine frames.
      knots: ``(B·crops, K)`` grid-pool CDF knots in ``[0, 1]``, or ``None``
        for ``coarse_len`` uniform coarse locations.
      t_in: input clip length (scales the knots to frames).
      ratio: divisor on the coarse frame location.
      crops: multi-crop factor; crop ``i`` starts ``i·stride`` frames later.

    Each coarse location gets a Gaussian bump over fine time with std 1/8 of
    the valid fine frames, max-normalised over fine time."""
    meta = meta.to(torch.float32)
    dev = meta.device
    st, step = meta[:, 0], meta[:, 3]
    b = meta.shape[0]
    len_f = feat_mask.shape[1]
    if crops > 1:
        offset = step[:, None] * torch.arange(crops, dtype=torch.float32,
                                              device=dev)[None, :]
        st = (st[:, None] + offset).reshape(-1)
    b2 = b * crops
    if knots is not None:
        tl = knots * float(t_in)
    else:
        if coarse_len is None:
            raise ValueError("coarse_len is required when knots is None")
        tl = torch.arange(coarse_len, dtype=torch.float32,
                          device=dev)[None, :].expand(b2, coarse_len)
    mu = (tl + st[:, None]) / ratio
    t = torch.arange(len_f, dtype=torch.float32, device=dev)
    std = (1.0 / 8.0) * torch.sum(feat_mask.to(torch.float32), dim=1)
    std = torch.repeat_interleave(std, crops)
    d = t[None, :, None] - mu[:, None, :]
    f = torch.exp(-(d ** 2) / (2.0 * (std ** 2)[:, None, None] + 1e-16))
    return f / (torch.amax(f, dim=1, keepdim=True) + 1e-16)
