"""Coarse-stream training driver (counterpart of
``coarse_fine_networks_tpu/train/coarse_driver.py``).

Trains the coarse stream on clips plus the cached fine features, with the
fusion parameters (``rw``/``mix``) at 10× the learning rate (flattened to
the warmup rate inside the warmup window), ``train_phases_per_val`` train
phases per validation, logits resized without ``align_corners``, chunked
inference for long validation videos (``meta[:, 0]`` advanced per chunk),
multi-crop validation (the max over crops of the sigmoid probabilities),
the ``Charades_v1_localize`` CSV of 25 frames a video, checkpoints with the
input position, resume (in the saved epoch, where the JAX driver restarts
its epoch count at 0) and the preemption guard.

Beside the JAX driver's results (``train_map``, ``val_map``, with
``record_trajectory`` the ``trajectory`` of (step, lr, loss) and the
``train_map_log``) the port records per train step the host-clock
``step_ms`` (from asking for the batch to its loss and probabilities on
the host) and ``prefetch_wait_ms`` (the part spent waiting for the device
prefetcher), per validation ``val_s``, and after a resume
``resumed_from`` (the step and the input position).  Nothing is compiled,
so the JAX driver's ``val_jit_shapes`` has no counterpart.  ``remat``
recomputes each bottleneck in the backward, as the JAX driver's model
does.

``mesh_devices = N > 1`` trains data-parallel on N ranks
(:func:`..parallel.mesh.run_data_parallel`): each rank loads its rows of
every global batch (the loader's ``shard=``), the step reduces what the
global batch needs (:func:`.steps.make_train_step`), rank 0 gathers the
rows for the train mAP and writes the checkpoints, and validation with the
localize CSV runs unsharded on rank 0 while the others wait, as in the JAX
driver; ``run`` returns rank 0's results.
"""

from __future__ import annotations

import contextlib
import logging
import random
import time
from typing import Any, Dict

import numpy as np
import torch

from ..data import CharadesDataset, PrefetchLoader, collate_coarse
from ..metrics import APMeter, LocalizeCSVWriter, subsample_25
from ..models import CoarseNet, init_parameters
from ..models.surgery import set_bn_splits
from ..ops.resample import linear_resize
from ..parallel import mesh
from ..utils.hw import enable_compilation_cache
from .common import (driver_device, iter_train_batches, load_pretrained,
                     model_batch, preemption_guard, resume, save_train_state)
from .fine_driver import _add_ap_ranks, build_transforms, train_shard
from .optim import build_schedule
from .state import TrainState
from .steps import bn_aggregated, make_eval_step, make_train_step

log = logging.getLogger("cfn_torch")

PREFIX = "coarse_fineFEAT_charades"


def build_coarse_loaders(cfg):
    """The train loader (shuffled, whole batches) and the val loader
    (length-sorted, bucketed padding) over clips with their fine
    features."""
    train_t, val_t = build_transforms(cfg)
    common = dict(task="loc", frames=cfg.frames, gamma_tau=cfg.gamma_tau,
                  min_frames=cfg.min_frames, num_classes=cfg.num_classes,
                  crop_size=cfg.crop_size, fine_feat_dir=cfg.fine_feat_dir,
                  pack_dir=cfg.pack_dir, device=cfg.device)
    train_ds = CharadesDataset(cfg.anno, "training", cfg.root,
                               spatial_transform=train_t, crops=1, **common)
    val_ds = CharadesDataset(cfg.anno, "testing", cfg.root,
                             spatial_transform=val_t, crops=cfg.crops,
                             **common)

    def collate(b):
        return collate_coarse(b, pad_t_multiple=cfg.pad_t_multiple,
                              pad_label_multiple=cfg.pad_label_multiple)

    def val_collate(b):
        return collate_coarse(b, pad_t_multiple=cfg.pad_t_multiple,
                              pad_label_multiple=cfg.pad_label_multiple,
                              bucket=cfg.val_bucket)

    train_loader = PrefetchLoader(train_ds, cfg.batch_size, collate,
                                  shuffle=True, num_workers=cfg.num_workers,
                                  prefetch=cfg.prefetch, drop_last=True,
                                  seed=cfg.seed, shard=train_shard())
    val_loader = PrefetchLoader(
        val_ds, cfg.val_batch_size or 1, val_collate, shuffle=False,
        num_workers=cfg.num_workers, prefetch=cfg.prefetch,
        sort_key=val_ds.num_frames if cfg.val_length_sorted else None)
    return train_loader, val_loader


def _chunked_logits(apply_fn, mb: Dict[str, Any], t_lim: int
                    ) -> torch.Tensor:
    """Long-video eval in windows of ``t_lim`` frames, ``meta[:, 0]``
    advanced by ``t_lim`` per window (``train_coarse_fineFEAT.py:215-224``);
    ``apply_fn(clips, feats, feat_mask, meta)`` gives a window's logits."""
    clips = mb["clips"]
    t = clips.shape[1]
    outs = []
    meta = mb["meta"]
    for ti in range(0, t // t_lim + 1):
        part = clips[:, ti * t_lim:min(t, (ti + 1) * t_lim)]
        if part.shape[1] == 0:
            break
        outs.append(apply_fn(part, mb["feats"], mb["feat_mask"], meta))
        meta = meta.clone()
        meta[:, 0] += t_lim
    return torch.cat(outs, dim=1)


@contextlib.contextmanager
def _evaluating(model: CoarseNet, crops: int):
    """``model`` in eval mode with ``crops`` clips per sample, restored
    after."""
    was_training, old = model.training, model.crops
    model.eval()
    model.crops = crops
    try:
        yield model
    finally:
        model.crops = old
        model.train(was_training)


def run(cfg) -> Dict[str, Any]:
    """Train and validate the coarse stream under the preemption guard: an
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
    # sample the same clips (with num_workers=1; more workers interleave
    # the draws)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    if not cfg.fine_feat_dir:
        raise ValueError("coarse training needs fine_feat_dir")
    device = driver_device(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    anomaly = (torch.autograd.set_detect_anomaly(True) if cfg.debug_nans
               else contextlib.nullcontext())
    with anomaly:
        return _train(cfg, state_box, device, dtype)


def _train(cfg, state_box, device, dtype) -> Dict[str, Any]:
    train_loader, val_loader = build_coarse_loaders(cfg)
    log.info("train %d val %d videos", len(train_loader.dataset.data),
             len(val_loader.dataset.data))
    model = CoarseNet(cfg.x3d_version, cfg.num_classes,
                      dropout_rate=cfg.dropout, remat=cfg.remat)
    if cfg.base_bn_splits != 1:
        set_bn_splits(model, cfg.base_bn_splits)
    init_parameters(model, torch.Generator().manual_seed(cfg.seed))
    if cfg.kinetics_ckpt:
        load_pretrained(model, cfg.kinetics_ckpt)
        log.info("loaded pretrained %s", cfg.kinetics_ckpt)
    model.to(device)
    state = TrainState.create(model)
    sched = build_schedule(cfg, steps_per_epoch=len(train_loader))
    state_box["sched"] = sched
    state_box["loader"] = train_loader
    results: Dict[str, Any] = {"step_ms": [], "prefetch_wait_ms": [],
                               "val_s": []}
    epochs = resume(cfg, PREFIX, state, sched, train_loader, None, results)
    mesh.replicate(model)

    fusion_mult = cfg.fusion_lr_mult or 10.0
    train_step = make_train_step(
        model, align_corners=cfg.align_corners, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, fusion_lr_mult=fusion_mult,
        accum_steps=cfg.num_steps_per_update, grad_clip=cfg.grad_clip)
    eval_step = make_eval_step(model, align_corners=cfg.align_corners)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    tr_apm, val_apm = APMeter(), APMeter()
    s_times = max(max(len(train_loader), 1) // cfg.log_every_frac, 1)
    tot = {"loss": 0.0, "n": 0}
    k = cfg.train_phases_per_val
    # the JAX loop's cycles of k train phases and a validation, entered at
    # the restored epoch
    while epochs < cfg.max_epochs or epochs % k:
        epochs += 1
        waits: list = []
        t_prev = time.perf_counter()
        for mb, host_batches in iter_train_batches(train_loader, cfg,
                                                   waits=waits):
            step_i = state.step
            lr_val = sched.lr(step_i)
            # the reference's warmup writes one LR into every param group,
            # flattening the fusion group inside the window
            lr_f = (lr_val if sched.in_warmup(step_i)
                    else lr_val * fusion_mult)
            state, metrics = train_step(state, mb, lr_val, generator, lr_f)
            state_box["state"] = state
            loss = float(metrics["loss"])  # waits for the step
            tot["loss"] += loss
            tot["n"] += 1
            _add_ap_ranks(tr_apm, metrics["probs"].float().cpu().numpy(),
                          host_batches)
            results["step_ms"].append((time.perf_counter() - t_prev) * 1e3)
            results["prefetch_wait_ms"].append(waits[-1] * 1e3)
            step_i = state.step
            if cfg.record_trajectory:
                results.setdefault("trajectory", []).append(
                    (step_i, float(lr_val), loss))
            if step_i % s_times == 0:
                log.info("epoch %d step %d lr %.5f (fusion %.5f) loss %.4f "
                         "mAP %.4f", epochs, step_i, lr_val, lr_f,
                         tot["loss"] / max(tot["n"], 1), tr_apm.mean())
                results["train_map"] = tr_apm.mean()
                if cfg.record_trajectory:
                    results.setdefault("train_map_log", []).append(
                        (step_i, results["train_map"]))
                tr_apm.reset()
                tot = {"loss": 0.0, "n": 0}
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
            results["val_map"] = _validate(cfg, state, model, val_loader,
                                           eval_step, val_apm, device, dtype)
            log.info("epoch %d VAL mAP(25fr) %.4f", epochs,
                     results["val_map"])
        mesh.barrier()
        results["val_s"].append(time.perf_counter() - t_val)
        sched.epoch_step()
        if cfg.max_steps and state.step >= cfg.max_steps:
            return results
    return results


def _validate(cfg, state, model, val_loader, eval_step, val_apm, device,
              dtype) -> float:
    """One validation pass: the 25-frame mAP, and the localize CSV rows."""
    bn_aggregated(state)
    writer = (LocalizeCSVWriter(cfg.localize_csv) if cfg.localize_csv
              else None)
    crops = cfg.crops
    nval = 0
    try:
        with _evaluating(model, crops), torch.no_grad():
            for batch in val_loader:
                mb = model_batch(batch, dtype, device)
                if mb["clips"].shape[1] < cfg.t_lim_inference + 5:
                    probs = eval_step(state, mb, crops)["probs"]
                else:
                    logits = _chunked_logits(model, mb, cfg.t_lim_inference)
                    tl = mb["labels"].shape[1]
                    logits = linear_resize(logits, tl, cfg.align_corners)
                    if crops > 1:  # max over the crops' probabilities
                        logits = logits.reshape(
                            (logits.shape[0] // crops, crops)
                            + tuple(logits.shape[1:]))
                        probs = torch.amax(torch.sigmoid(logits), dim=1)
                    else:
                        probs = torch.sigmoid(logits)
                    probs = probs * mb["masks"][:, :, None]
                probs = probs.float().cpu().numpy()
                valid = batch["masks"].sum(axis=1).astype(int)
                for b in range(probs.shape[0]):
                    p25, l25 = subsample_25(probs[b], valid[b],
                                            batch["labels"][b])
                    val_apm.add(p25, l25)
                    if writer is not None:
                        writer.add_video(batch["vids"][b], p25,
                                         float(batch["durs"][b]))
                nval += 1
                if cfg.max_val_batches and nval >= cfg.max_val_batches:
                    break
    finally:
        if writer is not None:
            writer.close()
    val_map = val_apm.mean()
    val_apm.reset()
    return val_map
