"""Fine-stream training driver (counterpart of
``coarse_fine_networks_tpu/train/fine_driver.py``).

Trains ``FineNet(task='loc')`` on whole-clip batches from the Kinetics
checkpoint (its class head kept fresh when the class count differs):
``train_phases_per_val`` train phases then one validation, each
validation on the split statistics aggregated into the eval statistics;
a video shorter than ``t_lim_inference + 5`` frames is scored by the eval
step (``crops`` clips a sample, the max of their probabilities), a longer
one in windows of ``t_lim_inference`` frames; the per-frame mAP over
valid frames; a checkpoint every ``ckpt_every`` steps; logits resized with
``align_corners``.  With ``multigrid`` the X3D long cycle sets each
epoch's clip window, crop, batch and batch-norm splits
(:class:`.multigrid.LongCycleRunner`), and ``results["multigrid_phases"]``
records each phase.

Beside the JAX driver's results the port records ``step_ms``,
``prefetch_wait_ms``, ``val_s`` and ``resumed_from``, as
:mod:`.coarse_driver` does.  A resumed run continues in the saved epoch,
so under the long cycle in the saved phase; the JAX driver restarts its
epoch count at 0, which puts a run resumed in phase C back at phase A's
shapes against a loader position counted in phase C's batches.
``remat`` recomputes each bottleneck in the backward, as the JAX driver's
model does.  ``mesh_devices = N > 1`` trains data-parallel on N ranks as
:mod:`.coarse_driver` does; the long cycle's batch-norm splits hold per
rank while every phase's local batch divides by its split count
(:class:`..models.layers.SubBatchNorm`).
"""

from __future__ import annotations

import contextlib
import logging
import random
import time
from typing import Any, Dict

import numpy as np
import torch

from ..data.dataset import CharadesDataset, collate_clips
from ..data.loader import PrefetchLoader
from ..data.transforms import (CenterCropScaled, Compose,
                               MultiScaleRandomCropMultigrid,
                               RandomHorizontalFlip)
from ..metrics import APMeter
from ..models import FineNet, init_parameters
from ..models.surgery import set_bn_splits
from ..parallel import mesh
from ..utils.hw import enable_compilation_cache
from .common import (driver_device, iter_train_batches, load_pretrained,
                     model_batch, preemption_guard, resume, save_train_state)
from .multigrid import LongCycleRunner, LongCycleSchedule
from .optim import build_schedule
from .state import TrainState
from .steps import (bn_aggregated, crop_reduced_loss, make_eval_step,
                    make_train_step, t_chunks)

log = logging.getLogger("cfn_torch")

PREFIX = "fine_charades"


def build_transforms(cfg):
    """Train: ``MultiScaleRandomCropMultigrid`` + a deferred horizontal
    flip; val: ``CenterCropScaled``.  ToTensor and Normalize run on the
    device."""
    train_t = Compose([
        MultiScaleRandomCropMultigrid(list(cfg.scales), cfg.crop_size),
        RandomHorizontalFlip(deferred=True),
    ])
    val_t = Compose([CenterCropScaled(cfg.crop_size)])
    return train_t, val_t


def train_shard():
    """The train loader's ``shard=``: this rank's ``(rank, world)`` in a
    data-parallel group, else None."""
    return mesh.process_shard() if mesh.world() > 1 else None


def build_fine_loaders(cfg):
    """The train loader (shuffled, whole batches) and the val loader
    (length-sorted, bucketed padding, ``val_batch_size`` or half the train
    batch) over clips and their frame labels."""
    train_t, val_t = build_transforms(cfg)
    common = dict(task="loc", frames=cfg.frames, gamma_tau=cfg.gamma_tau,
                  min_frames=cfg.min_frames, num_classes=cfg.num_classes,
                  crop_size=cfg.crop_size, pack_dir=cfg.pack_dir,
                  device=cfg.device)
    train_ds = CharadesDataset(cfg.anno, "training", cfg.root,
                               spatial_transform=train_t, crops=1, **common)
    val_ds = CharadesDataset(cfg.anno, "testing", cfg.root,
                             spatial_transform=val_t, crops=cfg.crops,
                             **common)

    def collate(b):
        return collate_clips(b, cfg.pad_t_multiple, cfg.pad_label_multiple)

    def val_collate(b):
        return collate_clips(b, cfg.pad_t_multiple, cfg.pad_label_multiple,
                             bucket=cfg.val_bucket)

    train_loader = PrefetchLoader(train_ds, cfg.batch_size, collate,
                                  shuffle=True, num_workers=cfg.num_workers,
                                  prefetch=cfg.prefetch, drop_last=True,
                                  seed=cfg.seed, shard=train_shard())
    val_loader = PrefetchLoader(
        val_ds, cfg.val_batch_size or max(cfg.batch_size // 2, 1),
        val_collate, shuffle=False, num_workers=cfg.num_workers,
        prefetch=cfg.prefetch,
        sort_key=val_ds.num_frames if cfg.val_length_sorted else None)
    return train_loader, val_loader


def _add_ap(apm: APMeter, probs: np.ndarray, labels: np.ndarray,
            masks: np.ndarray) -> None:
    """Accumulate AP over each sample's valid frames."""
    valid = masks.sum(axis=1).astype(int)
    for b in range(labels.shape[0]):
        apm.add(probs[b, :valid[b]], labels[b, :valid[b]])


def _add_ap_batches(apm: APMeter, probs: np.ndarray, host_batches) -> None:
    """Accumulate AP for one train step (host probabilities); with gradient
    accumulation ``probs`` has a leading micro-step axis matching
    ``host_batches``."""
    if len(host_batches) > 1:
        for i, hb in enumerate(host_batches):
            _add_ap(apm, probs[i], hb["labels"], hb["masks"])
    else:
        _add_ap(apm, probs, host_batches[0]["labels"],
                host_batches[0]["masks"])


def _add_ap_ranks(apm: APMeter, probs: np.ndarray, host_batches) -> None:
    """:func:`_add_ap_batches` for the global batch: every rank's rows and
    labels, gathered to rank 0 in rank order (the others add nothing)."""
    parts = mesh.all_gather_objects(
        (probs, [{"labels": hb["labels"], "masks": hb["masks"]}
                 for hb in host_batches]))
    if mesh.rank() == 0:
        for p, hbs in parts:
            _add_ap_batches(apm, p, hbs)


def run(cfg) -> Dict[str, Any]:
    """Train and validate the fine stream under the preemption guard: an
    interruption (SIGTERM, an error) checkpoints the latest step before it
    propagates, and ``maybe_resume`` continues from it.  On
    ``cfg.mesh_devices`` ranks (rank 0's results)."""
    enable_compilation_cache()
    return mesh.run_data_parallel(_run, cfg)


def _run(cfg) -> Dict[str, Any]:
    state_box: Dict[str, Any] = {"state": None, "sched": None}
    with preemption_guard(cfg, PREFIX, state_box):
        return _run_impl(cfg, state_box)


def _run_impl(cfg, state_box) -> Dict[str, Any]:
    # the transforms draw crops and flips from the global `random` module
    # (the reference's protocol): seeded, two runs of one configuration
    # sample the same clips (with num_workers=1)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    device = driver_device(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    anomaly = (torch.autograd.set_detect_anomaly(True) if cfg.debug_nans
               else contextlib.nullcontext())
    with anomaly:
        return _train(cfg, state_box, device, dtype)


def _train(cfg, state_box, device, dtype) -> Dict[str, Any]:
    train_loader, val_loader = build_fine_loaders(cfg)
    log.info("train %d val %d videos", len(train_loader.dataset.data),
             len(val_loader.dataset.data))
    model = FineNet(cfg.x3d_version, cfg.num_classes, task="loc",
                    dropout_rate=cfg.dropout, global_tower=False,
                    remat=cfg.remat)
    if cfg.base_bn_splits != 1:
        set_bn_splits(model, cfg.base_bn_splits)
    init_parameters(model, torch.Generator().manual_seed(cfg.seed))
    if cfg.kinetics_ckpt:
        load_pretrained(model, cfg.kinetics_ckpt)
        log.info("loaded pretrained %s", cfg.kinetics_ckpt)
    model.to(device)
    state = TrainState.create(model)
    # the schedule and the log period count the base batch's epochs
    sched = build_schedule(cfg, steps_per_epoch=len(train_loader))
    s_times = max(max(len(train_loader), 1) // cfg.log_every_frac, 1)
    state_box["sched"] = sched
    state_box["loader"] = train_loader
    results: Dict[str, Any] = {"step_ms": [], "prefetch_wait_ms": [],
                               "val_s": []}
    cycle = None
    if cfg.multigrid:
        cycle = LongCycleRunner(
            LongCycleSchedule(cfg.frames, cfg.crop_size, cfg.batch_size,
                              epochs_per_phase=cfg.multigrid_epochs_per_phase),
            train_loader, model, cfg.base_bn_splits, window_scale=2)
        results["multigrid_phases"] = cycle.phases
    epochs = resume(cfg, PREFIX, state, sched, train_loader, cycle, results)
    mesh.replicate(model)

    train_step = make_train_step(
        model, align_corners=cfg.align_corners, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, accum_steps=cfg.num_steps_per_update,
        grad_clip=cfg.grad_clip)
    eval_step = make_eval_step(model, align_corners=cfg.align_corners)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    tr_apm, val_apm = APMeter(), APMeter()
    tot = {"loss": 0.0, "cls": 0.0, "loc": 0.0, "n": 0}
    k = cfg.train_phases_per_val
    # the JAX loop's cycles of k train phases and a validation, entered at
    # the restored epoch
    while epochs < cfg.max_epochs or epochs % k:
        epochs += 1
        cur_bs = (cfg.batch_size if cycle is None
                  else cycle.apply(epochs - 1))
        waits: list = []
        t_prev = time.perf_counter()
        for mb, host_batches in iter_train_batches(
                train_loader, cfg, batch_size=cur_bs, waits=waits):
            lr = sched.lr(state.step)
            state, metrics = train_step(state, mb, lr, generator)
            state_box["state"] = state
            loss = float(metrics["loss"])  # waits for the step
            tot["loss"] += loss
            tot["cls"] += float(metrics["cls_loss"])
            tot["loc"] += float(metrics["loc_loss"])
            tot["n"] += 1
            _add_ap_ranks(tr_apm, metrics["probs"].float().cpu().numpy(),
                          host_batches)
            results["step_ms"].append((time.perf_counter() - t_prev) * 1e3)
            results["prefetch_wait_ms"].append(waits[-1] * 1e3)
            step_i = state.step
            if cfg.record_trajectory:
                results.setdefault("trajectory", []).append(
                    (step_i, float(lr), loss))
            if step_i % s_times == 0:
                n = max(tot["n"], 1)
                log.info("epoch %d step %d lr %.5f loss %.4f cls %.4f "
                         "loc %.4f mAP %.4f", epochs, step_i, lr,
                         tot["loss"] / n, tot["cls"] / n, tot["loc"] / n,
                         tr_apm.mean())
                results["train_map"] = tr_apm.mean()
                if cfg.record_trajectory:
                    results.setdefault("train_map_log", []).append(
                        (step_i, results["train_map"]))
                tr_apm.reset()
                tot = {"loss": 0.0, "cls": 0.0, "loc": 0.0, "n": 0}
            if step_i % cfg.ckpt_every == 0:
                save_train_state(cfg, PREFIX, state, sched,
                                 loader=train_loader)
            if cfg.max_steps and step_i >= cfg.max_steps:
                break
            t_prev = time.perf_counter()
        if cfg.max_steps and state.step >= cfg.max_steps:
            return results
        if epochs % k:
            continue
        t_val = time.perf_counter()
        bn_aggregated(state)
        if mesh.rank() == 0:  # unsharded, as in the JAX driver
            val_map, val_loss = _validate(cfg, state, val_loader, eval_step,
                                          val_apm, device, dtype)
            log.info("epoch %d VAL loss %.4f mAP %.4f", epochs, val_loss,
                     val_map)
            results["val_map"] = val_map
            results["val_loss"] = val_loss
        mesh.barrier()
        results["val_s"].append(time.perf_counter() - t_val)
        sched.epoch_step()
        if cfg.max_steps and state.step >= cfg.max_steps:
            return results
    return results


def _validate(cfg, state, val_loader, eval_step, val_apm, device,
              dtype) -> tuple:
    """One validation pass on the aggregated statistics: the per-frame mAP
    over valid frames and the mean loss."""
    bn_aggregated(state)
    model = state.model
    vloss, nval = 0.0, 0
    with torch.no_grad():
        for batch in val_loader:
            mb = model_batch(batch, dtype, device)
            if mb["clips"].shape[1] < cfg.t_lim_inference + 5:
                out = eval_step(state, mb, cfg.crops)
            else:  # long videos in bounded windows
                was_training = model.training
                model.eval()
                try:
                    logits = torch.cat(
                        [model(part) for part in
                         t_chunks(mb["clips"], cfg.t_lim_inference)], dim=1)
                finally:
                    model.train(was_training)
                out = crop_reduced_loss(logits, mb, cfg.crops,
                                        cfg.align_corners)
            vloss += float(out["loss"])
            nval += 1
            _add_ap(val_apm, out["probs"].float().cpu().numpy(),
                    batch["labels"], batch["masks"])
            if cfg.max_val_batches and nval >= cfg.max_val_batches:
                break
    val_map = val_apm.mean()
    val_apm.reset()
    return val_map, vloss / max(nval, 1)
