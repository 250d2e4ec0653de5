"""Train and eval steps of both streams (counterpart of
``coarse_fine_networks_tpu/train/steps.py``).

One train step: forward in training mode, logits resized to the label
length, masked sigmoid probabilities, the detection loss, backward (the
bottleneck entries through their CUDA kernels on the card), an optional
global-norm gradient clip and one SGD update.  The batch is the JAX
package's dict: ``clips (B, T, H, W, 3)`` in the compute dtype,
``labels (B, T_l, C)`` and ``masks (B, T_l)``, and for the coarse stream
``feats`` (five ``(B, T_f, 7, 7, C)`` banks), ``feat_mask (B, T_f)`` and
``meta (B, 4)``; a batch without ``feats`` drives a model that takes the
clips alone (the fine stream).  With ``accum_steps > 1`` every entry
carries a leading micro-batch axis.  The state is updated in place and
returned.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from ..models.layers import aggregate_sub_bn_stats
from ..ops.resample import linear_resize
from ..parallel import mesh
from .losses import detection_loss
from .state import TrainState


def _to(v, device):
    if isinstance(v, dict):
        return {k: _to(x, device) for k, x in v.items()}
    return v.to(device)


def _logits(model: nn.Module, batch: Dict[str, Any],
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if "feats" not in batch:
        return model(batch["clips"], generator=generator)
    return model(batch["clips"], batch["feats"], batch["feat_mask"],
                 batch["meta"], generator=generator)


def _forward_and_loss(model, batch, generator, align_corners):
    """Model → logits resized to the label length → masked probabilities →
    detection loss (under data parallelism this rank's share of the global
    batch's)."""
    logits = _logits(model, batch, generator)
    logits = linear_resize(logits, batch["labels"].shape[1],
                           align_corners=align_corners)
    probs = torch.sigmoid(logits) * batch["masks"][:, :, None]
    total, cls, loc = detection_loss(probs, batch["labels"], batch["masks"],
                                     across_ranks=True)
    return total, cls, loc, probs


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(
    model: nn.Module,
    align_corners: bool = True,
    momentum: float = 0.9,
    weight_decay: float = 1e-5,
    fusion_lr_mult: Optional[float] = None,
    accum_steps: int = 1,
    grad_clip: Optional[float] = None,
) -> Callable:
    """Build the train step ``step(state, batch, lr, generator=None,
    lr_fusion=None) -> (state, metrics)``.

    Args:
      align_corners: logit-resize convention — ``True`` for the fine
        driver, ``False`` for the coarse driver.
      fusion_lr_mult: if set, parameters whose names contain ``rw``/``mix``
        train at ``lr · mult``; ``lr_fusion`` passed to the step overrides
        ``lr · mult`` (the drivers flatten the fusion group to the warmup
        learning rate with it).
      accum_steps: gradient accumulation over micro-batches (a leading
        micro axis on every batch entry): one update from the mean of the
        micro-batch gradients, with the batch-norm statistics chained
        through the micro-batches in order.
      grad_clip: optional clip of the global L2 norm of the gradient,
        ``g · clip / max(clip, |g|)``, before the update.

    ``generator`` draws the dropout masks (on the model's device); it is
    needed when the model's dropout rate is above 0.  ``metrics`` holds
    ``loss``, ``cls_loss``, ``loc_loss`` and the masked ``probs``, detached
    (with ``accum_steps > 1`` the losses are means over the micro-batches
    and the probabilities are stacked).

    Under data parallelism (:mod:`..parallel.mesh`) ``batch`` is this
    rank's rows of the global batch: the batch-norm statistics and the
    loss's normalisers are the global batch's, each rank's loss is its
    share of the global loss, the gradients are summed over the ranks in
    one bucket after the backward (before the clip, which then sees the
    global norm), and the reported losses are the global batch's; the
    probabilities are this rank's rows.  Every rank's ``generator`` must be
    in the same state (dropout draws the global batch's masks)."""

    def step(state: TrainState, batch: Dict[str, Any], lr: float,
             generator: Optional[torch.Generator] = None,
             lr_fusion: Optional[float] = None):
        model_ = state.model
        model_.train()
        batch = _to(batch, _device(model_))
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        terms: List[tuple] = []
        for i in range(accum_steps):
            mb = batch if accum_steps == 1 else _to_micro(batch, i)
            total, cls, loc, probs = _forward_and_loss(
                model_, mb, generator, align_corners)
            total.backward()
            terms.append((total.detach(), cls.detach(), loc.detach(),
                          probs.detach()))
        params = [p for g in opt.param_groups for p in g["params"]]
        for p in params:  # every parameter takes the update, as in JAX
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            mesh.all_reduce_grads(params)
            if accum_steps > 1:
                for p in params:
                    p.grad.div_(accum_steps)
            if grad_clip is not None:
                gnorm = torch.sqrt(sum(torch.sum(torch.square(p.grad.float()))
                                       for p in params))
                scale = grad_clip / torch.clamp(gnorm, min=grad_clip)
                for p in params:
                    p.grad.mul_(scale)
        for group in opt.param_groups:
            group["momentum"] = momentum
            group["weight_decay"] = weight_decay
            group["lr"] = lr
            if group["fusion"] and fusion_lr_mult:
                group["lr"] = (lr * fusion_lr_mult if lr_fusion is None
                               else lr_fusion)
        opt.step()
        state.step += 1
        losses = torch.stack([torch.stack(t[:3]) for t in terms])
        if mesh.world() > 1:  # the ranks' shares → the global batch's
            losses = mesh.all_reduce_sum(losses)
        total, cls, loc = losses.mean(dim=0)
        probs = (terms[0][3] if accum_steps == 1
                 else torch.stack([t[3] for t in terms]))
        metrics = {"loss": total, "cls_loss": cls, "loc_loss": loc,
                   "probs": probs}
        return state, metrics

    return step


def _to_micro(batch: Dict[str, Any], i: int) -> Dict[str, Any]:
    if isinstance(batch, dict):
        return {k: _to_micro(v, i) for k, v in batch.items()}
    return batch[i]


def crop_reduced_loss(logits: torch.Tensor, batch: Dict[str, Any],
                      crops: int, align_corners: bool
                      ) -> Dict[str, torch.Tensor]:
    """Eval tail: resize logits to the label length, max-reduce the
    probabilities over ``crops`` consecutive clips per sample, mask, and
    take the detection loss."""
    logits = linear_resize(logits, batch["labels"].shape[1],
                           align_corners=align_corners)
    if crops > 1:
        bn = logits.shape[0]
        logits = logits.reshape((bn // crops, crops) + tuple(logits.shape[1:]))
        probs = torch.amax(torch.sigmoid(logits), dim=1)
    else:
        probs = torch.sigmoid(logits)
    probs = probs * batch["masks"][:, :, None]
    total, cls, loc = detection_loss(probs, batch["labels"], batch["masks"])
    return {"loss": total, "cls_loss": cls, "loc_loss": loc, "probs": probs}


def make_eval_step(model: nn.Module, align_corners: bool = True) -> Callable:
    """Eval step ``step(state, batch, crops=1) -> metrics``: running-stat
    batch norm (aggregate the split statistics first, :func:`bn_aggregated`),
    no dropout, no gradient; with ``crops > 1`` the batch carries ``B·crops``
    clips and the probabilities are max-reduced over each sample's crops."""

    def step(state: TrainState, batch: Dict[str, Any], crops: int = 1):
        model_ = state.model
        was_training = model_.training
        model_.eval()
        try:
            with torch.no_grad():
                batch = _to(batch, _device(model_))
                logits = _logits(model_, batch, None)
                return crop_reduced_loss(logits, batch, crops, align_corners)
        finally:
            model_.train(was_training)

    return step


def t_chunks(clips: torch.Tensor, t_lim: int) -> List[torch.Tensor]:
    """Split a whole-video clip tensor into windows of at most ``t_lim``
    frames along axis 1 (the chunked-inference bound)."""
    t = clips.shape[1]
    out = []
    for ti in range(0, t // t_lim + 1):
        part = clips[:, ti * t_lim:min(t, (ti + 1) * t_lim)]
        if part.shape[1]:
            out.append(part)
    return out


def bn_aggregated(state: TrainState) -> TrainState:
    """Refresh every split batch norm's eval statistics from its split
    statistics, in place (training reads only the split statistics), and
    return the state."""
    aggregate_sub_bn_stats(state.model)
    return state
