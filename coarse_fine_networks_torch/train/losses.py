"""Detection losses (counterpart of
``coarse_fine_networks_tpu/train/losses.py``): ``BCELoss`` on sigmoid
probabilities, a classification term (mean BCE over max-over-time
probabilities) and a localisation term (sum BCE over masked frames,
normalised by ``sum(masks) · n_classes``), averaged."""

from __future__ import annotations

import math

import torch

from ..parallel import mesh

# torch BCELoss clamps each log term at -100 for numerical safety.
_LOG_CLAMP = -100.0
_TINY = math.exp(_LOG_CLAMP)


def bce_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on probabilities, with ``BCELoss``'s
    -100 log clamp.

    The clamp uses the double-``where`` form, so the backward is NaN-free at
    exactly saturated probabilities (masked frames carry ``p == 0``): in the
    clamped region the gradient is 0, as in the JAX package."""
    in_lo = probs > _TINY          # log(p) > -100
    in_hi = probs < 1.0            # log1p(-p) > -100
    logp = torch.where(in_lo, torch.log(torch.where(in_lo, probs, 1.0)),
                       _LOG_CLAMP)
    log1mp = torch.where(in_hi, torch.log1p(-torch.where(in_hi, probs, 0.0)),
                         _LOG_CLAMP)
    return -(targets * logp + (1.0 - targets) * log1mp)


def detection_loss(probs: torch.Tensor, labels: torch.Tensor,
                   masks: torch.Tensor, across_ranks: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``probs (B, T_l, C)`` (sigmoid probabilities, already masked),
    ``labels (B, T_l, C)``, ``masks (B, T_l)`` → ``(total, cls, loc)`` with
    ``total = (cls + loc) / 2``.  The max over time splits its gradient
    between ties (``torch.amax``), as JAX's does.

    With ``across_ranks`` in a data-parallel group (:mod:`..parallel.mesh`)
    the batch is this rank's rows of the global batch, and the terms are
    this rank's shares of the global batch's: the class term is divided by
    the global row count and the localisation term by the global
    ``Σmasks·C``, so the shares add up to the one-process loss."""
    n_classes = labels.shape[-1]
    if across_ranks and mesh.world() > 1:
        rows, frames = mesh.all_reduce_sum(torch.stack([
            masks.new_tensor(float(masks.shape[0])),
            torch.sum(masks).detach()]))
        cls = torch.sum(bce_loss(torch.amax(probs, dim=1),
                                 torch.amax(labels, dim=1))) / (rows
                                                                * n_classes)
        loc = torch.sum(bce_loss(probs, labels)) / (frames * n_classes)
        return (cls + loc) / 2.0, cls, loc
    cls = torch.mean(bce_loss(torch.amax(probs, dim=1),
                              torch.amax(labels, dim=1)))
    loc = torch.sum(bce_loss(probs, labels)) / (torch.sum(masks) * n_classes)
    return (cls + loc) / 2.0, cls, loc
