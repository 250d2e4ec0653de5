"""Softmax-free attention aggregation of fine features onto coarse time
(counterpart of ``coarse_fine_networks_tpu/ops/reweight.py``)::

    numer[b,l,h,w,c] = Σ_t feat[b,t,h,w,c]·gate[b,t,h,w]·mask[b,t]·align[b,t,l]
    denom[b,l,h,w]   = Σ_t gate[b,t,h,w]·mask[b,t]·align[b,t,l] + eps
    out = numer / denom

as two ``einsum`` contractions, never the reference's 6-D broadcast.
"""

from __future__ import annotations

import torch


def reweight_aggregate(feat: torch.Tensor, gate: torch.Tensor,
                       align: torch.Tensor, mask: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """``feat (B,T_f,H,W,C)``, ``gate (B,T_f,H,W)``, ``align (B,T_f,T_c)``,
    ``mask (B,T_f)`` → ``(B,T_c,H,W,C)``."""
    am = gate * mask[:, :, None, None].to(gate.dtype)
    denom = torch.einsum("bthw,btl->blhw", am, align) + eps
    numer = torch.einsum("bthwc,btl->blhwc", feat * am[..., None], align)
    return numer / denom[..., None]
