"""Strict loading of checkpoint tensors into a model, for serving and for
checkpoint conversion.

:func:`..train.common.load_pretrained` loads what fits and keeps the fresh
init of the rest, which suits pretraining (the 400 → 157 class head) but
would let a server answer with random weights.  Here every tensor of the
model must come from the file at its shape, and the file may hold nothing
else but what the caller names to drop."""

from __future__ import annotations

from typing import Dict, Iterable

import torch
from torch import nn

from ..models.layers import SubBatchNorm
from ..models.surgery import _rebuild_splits
from .checkpoint import load_checkpoint

# the reference's batch-norm step counters: no module of the port has them
# (the JAX package's converter skips them too)
_COUNTER = "num_batches_tracked"


def checkpoint_tensors(path: str) -> Dict[str, torch.Tensor]:
    """The model tensors of a checkpoint file, on the CPU: the port's
    driver payload (its ``variables``), a reference ``.pt``/``.pth`` (its
    ``model_state_dict``, or the dict itself) or a bare state dict."""
    raw = load_checkpoint(path)
    for key in ("variables", "model_state_dict"):
        if key in raw:
            return dict(raw[key])
    return dict(raw)


def match_bn_splits(model: nn.Module,
                    sd: Dict[str, torch.Tensor]) -> nn.Module:
    """Give every :class:`..models.layers.SubBatchNorm` of ``model`` the
    split count of its split statistics in ``sd`` (a checkpoint saved in
    long-cycle phase A, B or C carries 8, 4 or 2 splits), in place, so
    that a strict load takes them.  A norm whose statistics ``sd`` lacks
    keeps its count."""
    counts = {}
    for name, m in model.named_modules():
        if not isinstance(m, SubBatchNorm):
            continue
        v = sd.get(f"{name}.split_bn.running_mean")
        if v is None:
            continue
        n, rest = divmod(v.numel(), m.num_features)
        if rest or not n:
            raise ValueError(f"{name}.split_bn.running_mean has {v.numel()} "
                             f"values, not a multiple of {m.num_features}")
        counts[id(m)] = n
    return _rebuild_splits(model, lambda m: counts.get(id(m), m.num_splits))


def load_strict(model: nn.Module, sd: Dict[str, torch.Tensor],
                drop: Iterable[str] = ()) -> nn.Module:
    """Load ``sd`` into ``model`` in place, at the split counts it carries
    (:func:`match_bn_splits`).  Keys starting with a prefix in ``drop`` and
    the reference's ``num_batches_tracked`` counters are left out first;
    then raises ``ValueError`` naming every tensor of the model that
    ``sd`` lacks, every key of ``sd`` the model does not have and every
    shape that differs."""
    drop = tuple(drop)
    sd = {k: v for k, v in sd.items()
          if not k.endswith(_COUNTER) and not (drop and k.startswith(drop))}
    match_bn_splits(model, sd)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    shapes = sorted(f"{k}: {tuple(sd[k].shape)} != {tuple(own[k].shape)}"
                    for k in own if k in sd
                    and tuple(sd[k].shape) != tuple(own[k].shape))
    if missing or unexpected or shapes:
        raise ValueError(
            f"checkpoint does not match the model: {len(missing)} missing "
            f"{missing[:8]}, {len(unexpected)} unexpected {unexpected[:8]}, "
            f"{len(shapes)} of another shape {shapes[:8]}")
    model.load_state_dict(sd, strict=True)
    return model
