"""Sequence-parallel multi-stage fusion (counterpart of
``coarse_fine_networks_tpu/parallel/sequence.py``).

The fusion's attention contracts over fine time
(:func:`..ops.reweight.reweight_aggregate`); for very long videos the fine
banks can outgrow one card.  Here each rank of the process group
(:mod:`.mesh`) holds a contiguous shard of fine time, computes the partial
numerator and denominator over it, and one all-reduce adds them: the
sequence-parallel decomposition of an attention-like sum.
"""

from __future__ import annotations

import torch

from .mesh import all_reduce_sum, shard_batch


def sequence_sharded_reweight(feat: torch.Tensor, gate: torch.Tensor,
                              align: torch.Tensor, mask: torch.Tensor,
                              eps: float = 1e-6) -> torch.Tensor:
    """:func:`..ops.reweight.reweight_aggregate` with this rank's shard of
    fine time: ``feat (B, T_f/N, H, W, C)``, ``gate (B, T_f/N, H, W)``,
    ``align (B, T_f/N, T_c)``, ``mask (B, T_f/N)`` → the whole
    ``(B, T_c, H, W, C)`` on every rank.  The partial numerator and
    denominator are summed over the ranks in one all-reduce and ``eps``
    lands after the global sum, as in the JAX package; outside a group it
    is ``reweight_aggregate`` itself.  The backward sums the output's
    gradient over the ranks: each rank's loss is its share of the global
    loss, the port's data-parallel convention (:mod:`.mesh`)."""
    am = gate * mask[:, :, None, None].to(gate.dtype)
    denom = torch.einsum("bthw,btl->blhw", am, align)
    numer = torch.einsum("bthwc,btl->blhwc", feat * am[..., None], align)
    tot = all_reduce_sum(torch.cat([numer.reshape(-1), denom.reshape(-1)]))
    numer = tot[:numer.numel()].view(numer.shape)
    denom = tot[numer.numel():].view(denom.shape)
    return numer / (denom + eps)[..., None]


def shard_time(x: torch.Tensor, rank_: int | None = None,
               world_: int | None = None) -> torch.Tensor:
    """This rank's contiguous shard of ``x``'s time axis (axis 1), which
    must divide by the group's size (the JAX package's ``shard_time``
    places the same slices on its mesh)."""
    return shard_batch(x, leading_accum=True, rank_=rank_, world_=world_)
