"""Shared driver plumbing (counterpart of
``coarse_fine_networks_tpu/train/common.py``): the device batch, the
prefetched train batches, pretrained weights, and checkpoints with resume
and the preemption guard."""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
from typing import Any, Dict, List

import torch
from torch import nn

from ..ckpt import (checkpoint_tensors, latest_checkpoint, load_checkpoint,
                    save_checkpoint)
from ..data.device_prefetch import DevicePrefetcher
from ..data.transforms import CHARADES_MEAN, CHARADES_STD, device_normalize
from ..parallel import mesh
from .state import TrainState

log = logging.getLogger("cfn_torch")


def _on(v, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(v).to(device=device, dtype=dtype,
                                 non_blocking=True)


def prepare_clips(batch: Dict[str, Any], mean=CHARADES_MEAN,
                  std=CHARADES_STD, dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """uint8 ``clips (B, N, T, H, W, 3)`` with ``flip (B,)`` and
    ``clip_mask (B, T)`` → normalised clips ``(B·N, T, H, W, 3)`` in
    ``dtype`` on ``device``.

    The N crops of a sample fold into the batch, each with its sample's
    flip (training has N = 1, so this squeezes the crops axis); padded
    frames are zeroed after the normalisation, as the reference zero-pads
    normalised tensors.  Clips decoded on the card arrive as a device
    tensor made on a loader thread's stream, and are marked as used on this
    one."""
    clips = _on(batch["clips"], device)
    if clips.is_cuda:
        clips.record_stream(torch.cuda.current_stream(clips.device))
    b, n = clips.shape[:2]
    clips = clips.reshape((b * n,) + tuple(clips.shape[2:]))
    flip = torch.repeat_interleave(_on(batch["flip"], device, torch.bool), n)
    cm = torch.repeat_interleave(_on(batch["clip_mask"], device), n, dim=0)
    x = device_normalize(clips, flip, mean, std, out_dtype=dtype)
    return x * cm.to(dtype)[:, :, None, None, None]


def model_batch(batch: Dict[str, Any], dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda") -> Dict[str, Any]:
    """The device batch dict of the train and eval steps: ``clips`` from
    :func:`prepare_clips` (``dtype``: the model's compute dtype), ``labels``
    and ``masks``, and for the coarse stream ``feats``, ``feat_mask`` and
    ``meta``."""
    out = {"clips": prepare_clips(batch, dtype=dtype, device=device),
           "labels": _on(batch["labels"], device),
           "masks": _on(batch["masks"], device)}
    if "feats" in batch:
        out["feats"] = {k: _on(v, device) for k, v in batch["feats"].items()}
        out["feat_mask"] = _on(batch["feat_mask"], device)
        out["meta"] = _on(batch["meta"], device)
    return out


def driver_device(cfg) -> torch.device:
    """``cfg.device``; raises when it names the card and there is none (no
    driver falls back to the CPU)."""
    dev = torch.device(cfg.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {cfg.device!r}: no CUDA device")
    return dev


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_microbatches(mbs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack model batches along a new leading micro-step axis for the
    accumulating train step."""
    return _tree_map(lambda *xs: torch.stack(xs), *mbs)


def batch_shape_key(mb: Dict[str, Any]) -> tuple:
    """Hashable shape signature of a model batch (whether batches stack)."""
    out = []

    def visit(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                visit(x[k], path + (k,))
        else:
            out.append((path, tuple(x.shape)))
    visit(mb, ())
    return tuple(out)


def iter_train_batches(loader, cfg, batch_size=None, waits=None,
                       to_device=None):
    """Yield ``(device_batch, host_batches)`` for the train loop, the
    device batch (``to_device(host_batch, dtype, device)``, by default
    :func:`model_batch`) prepared ``cfg.device_prefetch`` batches ahead by a
    :class:`..data.device_prefetch.DevicePrefetcher` (on a side stream on
    the card), which appends to ``waits`` the seconds the loop waited for
    each batch.

    With ``cfg.num_steps_per_update > 1``, that many consecutive batches
    stack into one device batch with a leading micro-step axis; a shape
    change flushes the partial group.  Batches short of ``batch_size``
    (default ``cfg.batch_size``; under data parallelism the global batch,
    of which the loader yields this rank's ``batch_size / world`` rows) are
    skipped.  The loader is told of each
    batch the loop takes (:meth:`..data.loader.PrefetchLoader.consumed`),
    so a checkpoint's input position excludes the batches still held
    ahead."""
    accum = max(cfg.num_steps_per_update, 1)
    dtype = getattr(torch, cfg.compute_dtype)
    device = driver_device(cfg)
    local_bs = (batch_size or cfg.batch_size) // mesh.world()
    src = (b for b in loader if b["clips"].shape[0] == local_bs)
    put = to_device or model_batch
    prefetched = DevicePrefetcher(
        src, lambda b: (put(b, dtype, device), b),
        depth=max(1, cfg.device_prefetch), device=device, waits=waits)
    consumed = getattr(loader, "consumed", lambda n: None)
    pending_mb: list = []
    pending_host: list = []
    key_shape = None
    for mb, batch in prefetched:
        if accum == 1:
            consumed(1)
            yield mb, [batch]
            continue
        k = batch_shape_key(mb)
        if pending_mb and k != key_shape:
            log.warning("accum group flushed on shape change %s -> %s",
                        key_shape, k)
            consumed(len(pending_mb))
            pending_mb, pending_host = [], []
        key_shape = k
        pending_mb.append(mb)
        pending_host.append(batch)
        if len(pending_mb) == accum:
            consumed(accum)
            yield stack_microbatches(pending_mb), pending_host
            pending_mb, pending_host = [], []


def load_pretrained(model: nn.Module, path: str) -> nn.Module:
    """Partial restore of ``path`` into ``model``, in place: a reference
    torch ``.pt``/``.pth`` (its ``model_state_dict``, or the dict itself;
    its names are the port's) or the port's own ``.ckpt`` (its
    ``variables``).  A tensor missing from the file or of another shape
    (the 400 → 157 class head) keeps its fresh value.  A JAX-package
    ``.ckpt`` (flax msgpack) is not readable here: convert its variables
    with :func:`..ckpt.state_dict_from_jax`."""
    sd = checkpoint_tensors(path)
    own = model.state_dict()
    keep = {k: v for k, v in sd.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    skipped = sorted(k for k in sd if k in own and k not in keep)
    if skipped:
        log.info("pretrained: kept the fresh init of %s (shape mismatch)",
                 skipped)
    model.load_state_dict(keep, strict=False)
    return model


@contextlib.contextmanager
def preemption_guard(cfg, prefix: str, state_ref: dict):
    """Turn SIGTERM (the preemption signal) into ``SystemExit`` — on the
    main thread only, where a handler can be installed — and checkpoint the
    latest state in ``state_ref['state']`` when any exception escapes the
    block, before it propagates; :func:`maybe_resume` continues from it."""
    old = None
    if threading.current_thread() is threading.main_thread():
        def handler(signum, frame):
            raise SystemExit(128 + signum)
        old = signal.signal(signal.SIGTERM, handler)
    try:
        yield
    except BaseException:
        state = state_ref.get("state")
        if state is not None and state_ref.get("sched") is not None:
            try:  # no collective: the other ranks may not be here
                path = save_train_state(cfg, prefix, state,
                                        state_ref["sched"],
                                        loader=state_ref.get("loader"),
                                        gather=False)
                if path is not None:
                    log.warning("preemption/crash checkpoint saved: %s",
                                path)
            except Exception:  # noqa: BLE001 — the original error wins
                log.exception("failed to save preemption checkpoint")
        raise
    finally:
        if old is not None:
            signal.signal(signal.SIGTERM, old)


def save_train_state(cfg, prefix: str, state: TrainState, sched,
                     loader=None, gather: bool = True) -> str | None:
    """Checkpoint the model, the optimizer (momentum), the step, the
    schedule and, with ``loader``, the input position to
    ``save_dir/<prefix>_<step:06d>.ckpt``; returns the path.

    Under data parallelism every rank calls this at the same step and
    rank 0 alone writes (the JAX package's one writer; every rank holds
    the same state); with ``gather`` the file also keeps each rank's own
    loader position (``rank_loaders``, gathered from the ranks), which
    :func:`maybe_resume` gives back to each rank.  The other ranks return
    None."""
    pos = loader.state_dict() if loader is not None else None
    ranks = (mesh.all_gather_objects(pos)
             if gather and pos is not None and mesh.world() > 1 else None)
    if mesh.rank() != 0:
        return None
    path = os.path.join(cfg.save_dir, f"{prefix}_{int(state.step):06d}.ckpt")
    payload = {"variables": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": int(state.step),
               "scheduler": sched.state_dict()}
    if pos is not None:
        payload["loader"] = pos
    if ranks is not None:
        payload["rank_loaders"] = ranks
    save_checkpoint(path, payload)
    log.info("saved checkpoint %s", path)
    return path


def maybe_resume(cfg, prefix: str, state: TrainState, sched,
                 loader=None, before_load=None) -> TrainState:
    """With ``cfg.resume``, restore the latest ``<prefix>`` checkpoint of
    ``cfg.save_dir`` into ``state`` (in place) and ``sched``, and with
    ``loader`` its input position.  ``before_load(payload)`` runs after
    the position is restored and before the model's tensors are (the long
    cycle gives the model the saved phase's batch-norm splits there).  The
    state is returned, unchanged when there is nothing to resume.  Every
    rank of a data-parallel group reads the same file and takes its own
    loader position when the file keeps one per rank of a group of this
    size (:func:`save_train_state`), else the file's."""
    if not cfg.resume:
        return state
    path = latest_checkpoint(cfg.save_dir, prefix)
    if path is None:
        return state
    raw = load_checkpoint(path)
    log.info("resuming from %s (step %d)", path, raw["step"])
    sched.load_state_dict(raw["scheduler"])
    ranks = raw.get("rank_loaders")
    if ranks is not None and len(ranks) == mesh.world():
        raw["loader"] = ranks[mesh.rank()]
    if loader is not None and "loader" in raw:
        loader.load_state_dict(raw["loader"])
    if before_load is not None:
        before_load(raw)
    state.model.load_state_dict(raw["variables"], strict=True)
    state.optimizer.load_state_dict(raw["optimizer"])
    state.step = int(raw["step"])
    return state


def resume(cfg, prefix: str, state: TrainState, sched, loader,
           cycle, results: Dict[str, Any]) -> int:
    """:func:`maybe_resume` with the input position; under the long cycle
    (``cycle``: a :class:`.multigrid.LongCycleRunner`, or None) the saved
    epoch's phase is applied first, so the model has the saved split
    statistics' shapes.  Records ``resumed_from`` and returns the epoch to
    continue in (0 for a fresh run)."""
    def before_load(raw):
        if cycle is not None and "loader" in raw:
            cycle.apply(int(raw["loader"]["epoch"]))

    maybe_resume(cfg, prefix, state, sched, loader=loader,
                 before_load=before_load)
    if not state.step:
        return 0
    pos = loader.state_dict()
    results["resumed_from"] = {"step": state.step, "epoch": pos["epoch"],
                               "pos": pos["pos"]}
    return pos["epoch"]
