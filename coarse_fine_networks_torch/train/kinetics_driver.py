"""Kinetics-style pretraining driver (counterpart of
``coarse_fine_networks_tpu/train/kinetics_driver.py``).

Trains ``FineNet(task='class')`` (the head's features averaged over T, H
and W) under label-smoothed softmax cross-entropy on ``logits[:, 0]`` in
f32, SGD with momentum and weight decay, dropout masks from a
``torch.Generator``; validates top-1 on the aggregated statistics after
every epoch, and saves a last checkpoint ``kinetics_x3d_<step>.ckpt`` that
the detection drivers' ``kinetics_ckpt`` partially restores (their class
heads keep the fresh init).  ``lr_schedule='cosine'``,
``label_smoothing`` and ``multigrid`` (the long cycle, the dataset's
``frames`` being the clip's true length) are the at-scale recipe's knobs.

Beside the JAX driver's results (``train_loss``, ``train_top1``,
``val_top1``, ``multigrid_phases``) the port records ``step_ms``,
``prefetch_wait_ms``, ``val_s``, ``resumed_from`` and, with
``record_trajectory``, the ``trajectory`` of (step, lr, loss).  The batches
go through the device prefetcher (:func:`.common.iter_train_batches`); a
resumed run continues in the saved epoch (the JAX driver restarts its
count at 0).  ``remat`` recomputes each bottleneck in the backward, as
the JAX driver's model does.  ``mesh_devices = N > 1`` trains
data-parallel on N ranks as :mod:`.coarse_driver` does; validation runs
unsharded on rank 0 while the others wait (the JAX driver shards it; the
top-1 is the same).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import random
import time
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..data.kinetics import KineticsDataset, collate_kinetics
from ..data.loader import PrefetchLoader
from ..models import FineNet, init_parameters
from ..models.surgery import set_bn_splits
from ..parallel import mesh
from ..utils.hw import enable_compilation_cache
from .common import (driver_device, iter_train_batches, preemption_guard,
                     prepare_clips, resume, save_train_state)
from .fine_driver import build_transforms, train_shard
from .multigrid import LongCycleRunner, LongCycleSchedule
from .optim import build_schedule
from .state import TrainState
from .steps import bn_aggregated

log = logging.getLogger("cfn_torch")

PREFIX = "kinetics_x3d"


def class_batch(batch: Dict[str, Any], dtype: torch.dtype = torch.float32,
                device: "str | torch.device" = "cuda") -> Dict[str, Any]:
    """The device batch of the class steps: normalised ``clips`` and int64
    ``labels``."""
    return {"clips": prepare_clips(batch, dtype=dtype, device=device),
            "labels": torch.as_tensor(batch["labels"]).to(
                device=device, dtype=torch.int64, non_blocking=True)}


def smoothed_ce(logits: torch.Tensor, labels: torch.Tensor,
                smoothing: float = 0.0) -> torch.Tensor:
    """Per-sample label-smoothed softmax cross-entropy in f32:
    ``(1-eps)·NLL(target) + eps·mean_c(-log p_c)``; ``smoothing=0`` is the
    plain cross-entropy."""
    logp = torch.log_softmax(logits.float(), dim=1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    if smoothing == 0.0:
        return nll
    return (1.0 - smoothing) * nll + smoothing * (-logp.mean(dim=1))


def _top1(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=1) == labels).float().mean()


def make_class_train_step(model: nn.Module, momentum: float = 0.9,
                          weight_decay: float = 5e-5,
                          label_smoothing: float = 0.0):
    """The class train step ``step(state, batch, lr, generator=None) ->
    (state, {"loss", "acc"})``: forward in training mode, the mean smoothed
    cross-entropy of ``logits[:, 0]``, backward, one SGD update (every
    parameter, as in JAX); the state is updated in place.  ``generator``
    draws the dropout masks.  Under data parallelism
    (:mod:`..parallel.mesh`) the mean is over the global batch (each rank's
    loss is its rows' sum over the global row count), the gradients are
    summed over the ranks, and ``loss`` and ``acc`` are the global
    batch's."""

    def step(state: TrainState, batch: Dict[str, Any], lr: float,
             generator: "torch.Generator | None" = None):
        model_ = state.model
        model_.train()
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        logits = model_(batch["clips"], generator=generator)[:, 0].float()
        ce = smoothed_ce(logits, batch["labels"], label_smoothing)
        acc = _top1(logits.detach(), batch["labels"])
        if mesh.world() == 1:
            loss = ce.mean()
        else:  # this rank's share of the global batch's mean
            rows = mesh.all_reduce_sum(ce.new_tensor(float(ce.shape[0])))
            loss = ce.sum() / rows
        loss.backward()
        params = [p for g in opt.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            mesh.all_reduce_grads(params)
        for group in opt.param_groups:
            group.update(lr=lr, momentum=momentum,
                         weight_decay=weight_decay)
        opt.step()
        state.step += 1
        loss = loss.detach()
        if mesh.world() > 1:
            loss, acc = mesh.all_reduce_sum(torch.stack([
                loss, acc * ce.shape[0] / rows]))
        return state, {"loss": loss, "acc": acc}

    return step


def make_class_eval_step(model: nn.Module):
    """The class eval step ``step(state, batch) -> {"loss", "acc"}``: the
    eval statistics (aggregate the split statistics first), no dropout, no
    gradient."""

    def step(state: TrainState, batch: Dict[str, Any]):
        model_ = state.model
        was_training = model_.training
        model_.eval()
        try:
            with torch.no_grad():
                logits = model_(batch["clips"])[:, 0].float()
        finally:
            model_.train(was_training)
        return {"loss": smoothed_ce(logits, batch["labels"]).mean(),
                "acc": _top1(logits, batch["labels"])}

    return step


def run(cfg) -> Dict[str, Any]:
    """Pretrain under the preemption guard; ``cfg.anno`` is the
    Kinetics-style JSON (:mod:`..data.kinetics`).  On ``cfg.mesh_devices``
    ranks (rank 0's results)."""
    enable_compilation_cache()
    return mesh.run_data_parallel(_run, cfg)


def _run(cfg) -> Dict[str, Any]:
    state_box: Dict[str, Any] = {"state": None, "sched": None}
    with preemption_guard(cfg, PREFIX, state_box):
        return _run_impl(cfg, state_box)


def _run_impl(cfg, state_box) -> Dict[str, Any]:
    # seeded like the detection drivers (the JAX driver leaves the global
    # `random` of the crops and flips as it finds it)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    device = driver_device(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    anomaly = (torch.autograd.set_detect_anomaly(True) if cfg.debug_nans
               else contextlib.nullcontext())
    with anomaly:
        return _train(cfg, state_box, device, dtype)


def _train(cfg, state_box, device, dtype) -> Dict[str, Any]:
    train_t, val_t = build_transforms(cfg)
    common = dict(frames=cfg.frames, gamma_tau=cfg.gamma_tau,
                  min_frames=cfg.min_frames, crop_size=cfg.crop_size,
                  device=cfg.device)
    train_ds = KineticsDataset(cfg.anno, "training", cfg.root,
                               spatial_transform=train_t, **common)
    val_ds = KineticsDataset(cfg.anno, "validation", cfg.root,
                             spatial_transform=val_t, **common)
    log.info("kinetics train %d val %d videos", len(train_ds), len(val_ds))

    def collate(b):
        return collate_kinetics(b, cfg.pad_t_multiple)

    train_loader = PrefetchLoader(train_ds, cfg.batch_size, collate,
                                  shuffle=True, num_workers=cfg.num_workers,
                                  prefetch=cfg.prefetch, drop_last=True,
                                  seed=cfg.seed, shard=train_shard())
    val_loader = PrefetchLoader(val_ds, cfg.val_batch_size or cfg.batch_size,
                                collate, shuffle=False,
                                num_workers=cfg.num_workers)

    model = FineNet(cfg.x3d_version, cfg.num_classes, task="class",
                    dropout_rate=cfg.dropout, global_tower=False,
                    remat=cfg.remat)
    if cfg.base_bn_splits != 1:
        set_bn_splits(model, cfg.base_bn_splits)
    init_parameters(model, torch.Generator().manual_seed(cfg.seed))
    model.to(device)
    state = TrainState.create(model)
    sched = build_schedule(cfg, steps_per_epoch=max(
        len(train_ds) // max(cfg.batch_size, 1), 1))
    state_box["sched"] = sched
    state_box["loader"] = train_loader
    results: Dict[str, Any] = {"step_ms": [], "prefetch_wait_ms": [],
                               "val_s": []}
    cycle = None
    if cfg.multigrid:
        cycle = LongCycleRunner(
            LongCycleSchedule(cfg.frames, cfg.crop_size, cfg.batch_size,
                              epochs_per_phase=cfg.multigrid_epochs_per_phase),
            train_loader, model, cfg.base_bn_splits)
        results["multigrid_phases"] = cycle.phases
    epochs = resume(cfg, PREFIX, state, sched, train_loader, cycle, results)
    mesh.replicate(model)

    train_step = make_class_train_step(
        model, momentum=cfg.momentum, weight_decay=cfg.weight_decay,
        label_smoothing=cfg.label_smoothing)
    eval_step = make_class_eval_step(model)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    # the class step takes no micro-steps (the JAX driver ignores them)
    one_step_cfg = dataclasses.replace(cfg, num_steps_per_update=1)

    while epochs < cfg.max_epochs:
        epochs += 1
        cur_bs = (cfg.batch_size if cycle is None
                  else cycle.apply(epochs - 1))
        tot = {"loss": 0.0, "acc": 0.0, "n": 0}
        waits: list = []
        t_prev = time.perf_counter()
        for mb, _ in iter_train_batches(train_loader, one_step_cfg,
                                        batch_size=cur_bs, waits=waits,
                                        to_device=class_batch):
            lr = sched.lr(state.step)
            state, m = train_step(state, mb, lr, generator)
            state_box["state"] = state
            loss = float(m["loss"])  # waits for the step
            tot["loss"] += loss
            tot["acc"] += float(m["acc"])
            tot["n"] += 1
            results["step_ms"].append((time.perf_counter() - t_prev) * 1e3)
            results["prefetch_wait_ms"].append(waits[-1] * 1e3)
            step_i = state.step
            if cfg.record_trajectory:
                results.setdefault("trajectory", []).append(
                    (step_i, float(lr), loss))
            if step_i % cfg.ckpt_every == 0:
                save_train_state(cfg, PREFIX, state, sched,
                                 loader=train_loader)
            if cfg.max_steps and step_i >= cfg.max_steps:
                break
            t_prev = time.perf_counter()
        n = max(tot["n"], 1)
        log.info("kinetics epoch %d loss %.4f top1 %.4f", epochs,
                 tot["loss"] / n, tot["acc"] / n)
        results["train_loss"] = tot["loss"] / n
        results["train_top1"] = tot["acc"] / n
        if len(val_ds):
            t_val = time.perf_counter()
            bn_aggregated(state)
            if mesh.rank() == 0:
                results["val_top1"] = _validate(cfg, state, val_loader,
                                                eval_step, device, dtype)
                log.info("kinetics epoch %d VAL top1 %.4f", epochs,
                         results["val_top1"])
            mesh.barrier()
            results["val_s"].append(time.perf_counter() - t_val)
        sched.epoch_step()
        if cfg.max_steps and state.step >= cfg.max_steps:
            break
    save_train_state(cfg, PREFIX, state, sched, loader=train_loader)
    return results


def _validate(cfg, state, val_loader, eval_step, device, dtype) -> float:
    """Top-1 on the aggregated statistics, averaged over the batches."""
    bn_aggregated(state)
    acc, n = 0.0, 0
    for batch in val_loader:
        acc += float(eval_step(state, class_batch(batch, dtype,
                                                  device))["acc"])
        n += 1
        if cfg.max_val_batches and n >= cfg.max_val_batches:
            break
    return acc / max(n, 1)
