"""Charades clip datasets and padded-batch collation (counterpart of
``coarse_fine_networks_tpu/data/dataset.py``).

Clips come out channels-last uint8 ``(N_crops, T, H, W, 3)`` with a per-clip
flip flag, normalised later on the device (:func:`.transforms
.device_normalize`); labels are time-major ``(T_l, C)``.  The collates pad
the time axes up to fixed multiples, or geometric buckets, so that the
steps see few shapes; masks carry the true lengths.

Frames are decoded natively (:mod:`.native`: a hand-written host entropy
decoder, then hand-written IDCT-and-colour and crop-resize kernels on the
card, their plain versions on the CPU) where the spatial pipeline allows,
as the JAX package's datasets decode
with its C++ library: a ``CenterCropScaled``-only pipeline, or
``MultiScaleRandomCropMultigrid`` with a deferred flip for training;
otherwise with Pillow and the host transforms.  ``pack_dir`` reads a
video's frames from its ``.cfnpack`` container where one exists.  On the
card the natively decoded clips are uint8 device tensors, and the collates
stack them on the device.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from . import bufpool, native
from .annotations import make_dataset
from .transforms import (CenterCropScaled, Compose,
                         MultiScaleRandomCropMultigrid, RandomHorizontalFlip)

FEAT_CAP = 128  # fine-feature temporal cap (charades_coarse_fineFEAT.py:210)


def load_frame(root: str, vid: str, index: int) -> Optional[Image.Image]:
    """Frame ``root/<vid>/<vid>-%06d.jpg`` as RGB, or None if absent."""
    path = os.path.join(root, vid, f"{vid}-{index:06d}.jpg")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        with Image.open(f) as img:
            return img.convert("RGB")


def native_transforms(spatial_transform, decode_backend: str):
    """``(native_crop, native_train)`` as the JAX datasets choose them: the
    output size of a ``CenterCropScaled``-only pipeline, or the
    ``MultiScaleRandomCropMultigrid`` of one followed by a deferred flip;
    None for each the pipeline is not (or the backend is ``"pil"``).
    ``decode_backend="native"`` raises :class:`ValueError` where neither
    applies."""
    if decode_backend not in ("auto", "native", "pil"):
        raise ValueError(f"decode_backend={decode_backend!r}")
    use = decode_backend in ("auto", "native") and native.available()
    ts = (spatial_transform.transforms
          if isinstance(spatial_transform, Compose) else [])
    crop = (ts[0].size[0] if use and len(ts) == 1
            and isinstance(ts[0], CenterCropScaled) else None)
    train = (ts[0] if use and len(ts) == 2
             and isinstance(ts[0], MultiScaleRandomCropMultigrid)
             and isinstance(ts[1], RandomHorizontalFlip) and ts[1].deferred
             else None)
    if decode_backend == "native" and crop is None and train is None:
        raise ValueError(
            "native decode requires a CenterCropScaled-only or "
            "MultiScaleRandomCropMultigrid+deferred-flip transform")
    return crop, train


def deferred_flip(spatial_transform) -> bool:
    """The clip's drawn flip of a deferred :class:`RandomHorizontalFlip`."""
    flip = False
    for t in getattr(spatial_transform, "transforms", [spatial_transform]):
        if isinstance(t, RandomHorizontalFlip) and t.deferred:
            flip = t.flipped
    return flip


def stack(xs):
    """``np.stack`` of host arrays, ``torch.stack`` of device clips."""
    if xs and isinstance(xs[0], np.ndarray):
        return np.stack(xs)
    import torch

    return torch.stack(xs)


def load_clip_frames(root: str, vid: str, start: int, num: int,
                     stride: int) -> List[Image.Image]:
    """Frames ``start, start+stride, ...`` below ``start+num``, stopping at
    the first missing frame."""
    frames = []
    for i in range(start, start + num, stride):
        img = load_frame(root, vid, i)
        if img is None:
            break
        frames.append(img)
    return frames


class CharadesDataset:
    """Clip sampler over the Charades per-frame-JPEG layout, with the
    reference's sampling:

    * training: a random window of ``frames*2`` frames at stride
      ``gamma_tau*2``, its start drawn from ``random.Random(seed)``;
    * testing: the whole video from frame 1; for ``task='loc'`` with
      ``crops > 1`` the stride is divided by ``crops`` and N interleaved
      crop clips are built;
    * ``meta = [start_f, frames, nf, stride] // gamma_tau`` feeds the
      Gaussian alignment.

    With ``fine_feat_dir`` each sample also carries the video's cached fine
    features: ``<key>/<vid>.npy`` ``(T, 7, 7, C)``, or the reference's torch
    cache ``<key>/<vid>`` ``(1, C, T, 7, 7)``.

    ``decode_backend``: ``"auto"`` decodes natively where the pipeline
    allows (:func:`native_transforms`), ``"native"`` raises where it does
    not, ``"pil"`` always takes Pillow.  ``pack_dir``: the videos'
    ``.cfnpack`` containers, read by the native path (a video without one
    reads its JPEG files).  ``device``: where native decoding puts the
    clips, the card unless the caller asks for the CPU (host arrays, as
    the JAX package's).  The clip's random draws are the Pillow path's, in
    the same order, so a seeded run draws the same crops either way.
    """

    def __init__(
        self,
        split_file: str,
        split: str,
        root: str,
        spatial_transform=None,
        task: str = "loc",
        frames: int = 80,
        gamma_tau: int = 5,
        crops: int = 1,
        extract_feat: bool = False,
        fine_feat_dir: Optional[str] = None,
        feature_keys: Sequence[str] = ("layer1", "layer2", "layer3",
                                       "layer4", "conv5"),
        min_frames: Optional[int] = None,
        num_classes: int = 157,
        crop_size: int = 224,
        decode_backend: str = "auto",
        pack_dir: Optional[str] = None,
        seed: int = 0,
        device: str = "cuda",
    ):
        kwargs = {} if min_frames is None else {"min_frames": min_frames}
        self.data = make_dataset(split_file, split, root,
                                 num_classes=num_classes, **kwargs)
        self.root = root
        self.frames = frames * 2
        self.gamma_tau = gamma_tau * 2
        self.spatial_transform = spatial_transform
        self.crops = crops
        self.split = "testing" if extract_feat else split
        self.task = task
        self.fine_feat_dir = fine_feat_dir
        self.feature_keys = tuple(feature_keys)
        self.crop_size = crop_size  # the multigrid crop for the transforms
        self.native_crop, self.native_train = native_transforms(
            spatial_transform, decode_backend)
        native_any = (self.native_crop is not None
                      or self.native_train is not None)
        self.pack_dir = pack_dir if pack_dir and native_any else None
        self._pack_nf: Dict[str, int] = {}
        self.device = native.resolve_device(device)
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.data)

    def num_frames(self, index: int) -> int:
        """Frame count of video ``index`` (the length-sorting key)."""
        return self.data[index][3]

    def _load_feats(self, vid: str) -> Dict[str, np.ndarray]:
        """Cached fine features → ``(T_f, 7, 7, C)`` float32 per key."""
        feats = {}
        for k in self.feature_keys:
            path = os.path.join(self.fine_feat_dir, k, vid)
            if os.path.exists(path + ".npy"):
                f = np.load(path + ".npy")
            else:
                import torch

                f = torch.load(path, map_location="cpu", weights_only=True)
                f = np.transpose(f.squeeze(0).float().numpy(), (1, 2, 3, 0))
            feats[k] = np.asarray(f, np.float32)
        return feats

    def __getitem__(self, index: int):
        vid, label, dur, nf = self.data[index]
        label = np.asarray(label)
        if self.split == "testing":
            frames, start_f = nf, 1
        else:
            frames = min(self.frames, nf)
            start_f = self.rng.randint(1, max(self.gamma_tau, nf - frames))
        stride_f = self.gamma_tau
        if self.split == "testing" and self.task == "loc":
            stride_f = stride_f // self.crops

        use_native = (self.native_crop is not None
                      or (self.native_train is not None
                          and self.split != "testing"))
        with native.on_device(self.device if use_native else "cpu"):
            arr, flip = (self._native_frames(vid, start_f, frames, stride_f)
                         if use_native else
                         self._pil_frames(vid, start_f, frames, stride_f))
            clips = self._clips(arr, frames)
        label = label[start_f - 1:start_f - 1 + frames]
        if self.task == "class":
            label = label.max(axis=0)
        if self.split == "testing" and self.task != "class":
            label = label[:(frames // self.gamma_tau) * self.gamma_tau]

        meta = np.asarray([start_f // self.gamma_tau,
                           frames // self.gamma_tau, nf // self.gamma_tau,
                           stride_f // self.gamma_tau], np.int32)
        sample = {"clips": clips, "label": label.astype(np.float32),
                  "vid": vid, "meta": meta, "dur": float(dur), "flip": flip}
        if self.fine_feat_dir is not None:
            sample["feats"] = self._load_feats(vid)
        return sample

    def _pil_frames(self, vid, start_f, frames, stride_f):
        """Pillow and the host transforms: ``(T, H, W, 3)`` uint8 and the
        flip."""
        imgs = load_clip_frames(self.root, vid, start_f, frames, stride_f)
        flip = False
        if self.spatial_transform is not None:
            self.spatial_transform.randomize_parameters(self.crop_size)
            flip = deferred_flip(self.spatial_transform)
            imgs = [self.spatial_transform(img) for img in imgs]
        return np.stack([np.asarray(im, np.uint8) for im in imgs], 0), flip

    def _native_frames(self, vid, start_f, frames, stride_f):
        """The native decoder, from the video's pack (index ``f - 1`` holds
        frame ``f``, stopping at the pack's frame count) or its JPEG files
        (stopping at the first gap): ``(T, H, W, 3)`` uint8 and the flip.
        The train crop is drawn here, once per clip, as the Pillow path
        draws it."""
        pack, pack_nf = native.pack_for(self.pack_dir, vid, self._pack_nf)
        if pack is not None:
            indices = [i - 1 for i in range(start_f, start_f + frames,
                                            stride_f) if i - 1 < pack_nf]
        else:
            paths = []
            for i in range(start_f, start_f + frames, stride_f):
                p = os.path.join(self.root, vid, f"{vid}-{i:06d}.jpg")
                if not os.path.exists(p):
                    break  # stop at first gap (charades_fine.py:54-55)
                paths.append(p)
        dev = self.device
        if self.native_train is not None and self.split != "testing":
            self.spatial_transform.randomize_parameters(self.crop_size)
            mt = self.native_train
            flip = deferred_flip(self.spatial_transform)
            if pack is not None:
                return native.decode_packed_random_crop(
                    pack, indices, mt.size, mt.scale, mt.tl_x, mt.tl_y,
                    device=dev), flip
            return native.decode_batch_random_crop(
                paths, mt.size, mt.scale, mt.tl_x, mt.tl_y, device=dev), flip
        if pack is not None:
            return native.decode_packed(pack, indices, self.native_crop,
                                        device=dev), False
        return native.decode_batch(paths, self.native_crop,
                                   device=dev), False

    def _clips(self, arr, frames):
        """The frames ``(T, H, W, 3)`` as ``(N_crops, T', H, W, 3)``: one
        clip for training, ``crops`` spread or interleaved ones for
        testing."""
        if self.split != "testing":
            return arr[None]
        if self.task == "class":
            tclip = self.frames // self.gamma_tau
            step = (arr.shape[0] - 1 - tclip) // max(self.crops - 1, 1)
            if step <= 0:
                return stack([arr[:tclip]] * self.crops)
            return stack([arr[i:i + tclip]
                          for i in range(0, step * self.crops, step)])
        tclip = frames // self.gamma_tau
        return stack([arr[i::self.crops][:tclip] for i in range(self.crops)])

def _round_up(n: int, multiple: Optional[int]) -> int:
    if not multiple:
        return n
    return ((n + multiple - 1) // multiple) * multiple


def _bucket_up(n: int, multiple: Optional[int]) -> int:
    """Round up to ``multiple · 2^k``: O(log T) padded shapes."""
    if not multiple:
        return n
    m = multiple
    while m < n:
        m *= 2
    return m


def pad_clips(batch: List[dict], max_t: int):
    """The samples' clips ``(N, T, H, W, 3)`` zero-padded in time to
    ``max_t`` and stacked: ``(B, N, max_t, H, W, 3)`` uint8, in a pooled
    host buffer, or for natively decoded device clips on their device (on
    the thread's stream, synchronised before return, as the decode is)."""
    first = batch[0]["clips"]
    n, h, w = first.shape[0], *first.shape[2:4]
    shape = (len(batch), n, max_t, h, w, 3)
    host = isinstance(first, np.ndarray)
    with native.on_device("cpu" if host else first.device) as dev:
        if host:
            clips = bufpool.borrow(shape, np.uint8)
        else:
            import torch

            clips = torch.empty(shape, dtype=torch.uint8, device=dev)
        for i, b in enumerate(batch):
            t = b["clips"].shape[1]
            clips[i, :, :t] = b["clips"]
            clips[i, :, t:] = 0
    return clips


def collate_clips(batch: List[dict], pad_t_multiple: Optional[int] = None,
                  pad_label_multiple: Optional[int] = None,
                  bucket: bool = False) -> Dict[str, np.ndarray]:
    """Zero-pad clips and labels to the batch maximum, rounded up to a
    multiple (``bucket=True``: to a geometric bucket), and emit the masks:
    ``masks (B, T_l)`` of valid label frames and ``clip_mask (B, T)`` of
    valid input frames, which re-zeroes the padded frames after the device
    normalisation."""
    up = _bucket_up if bucket else _round_up
    max_t = up(max(b["clips"].shape[1] for b in batch), pad_t_multiple)
    max_l = up(max(b["label"].shape[0] for b in batch), pad_label_multiple)
    c = batch[0]["label"].shape[-1]

    # pooled buffers: only the padded tails are re-zeroed
    clips = pad_clips(batch, max_t)
    labels = bufpool.borrow((len(batch), max_l, c), np.float32)
    masks = bufpool.borrow((len(batch), max_l), np.float32, zero=True)
    clip_mask = bufpool.borrow((len(batch), max_t), np.float32, zero=True)
    for i, b in enumerate(batch):
        clip_mask[i, :b["clips"].shape[1]] = 1.0
        ln = b["label"].shape[0]
        labels[i, :ln] = b["label"]
        labels[i, ln:] = 0.0
        masks[i, :ln] = 1.0
    return {"clips": clips, "labels": labels, "masks": masks,
            "clip_mask": clip_mask,
            "meta": np.stack([b["meta"] for b in batch]),
            "flip": np.asarray([b["flip"] for b in batch]),
            "vids": [b["vid"] for b in batch],
            "durs": np.asarray([b["dur"] for b in batch], np.float32)}


def collate_coarse(batch: List[dict], feat_cap: int = FEAT_CAP,
                   pad_t_multiple: Optional[int] = None,
                   pad_label_multiple: Optional[int] = None,
                   bucket: bool = False) -> Dict[str, np.ndarray]:
    """:func:`collate_clips` plus the cached fine features, padded and
    capped at ``feat_cap`` frames, and their mask ``feat_mask (B, T_f)``."""
    out = collate_clips(batch, pad_t_multiple, pad_label_multiple,
                        bucket=bucket)
    keys = list(batch[0]["feats"].keys())
    max_f = max(b["feats"][keys[0]].shape[0] for b in batch)
    if bucket:
        max_f = _bucket_up(max_f, 16)
    max_f = min(max_f, feat_cap)
    feats = {}
    for k in keys:
        c = batch[0]["feats"][k].shape[-1]
        f = bufpool.borrow((len(batch), max_f, 7, 7, c), np.float32)
        for i, b in enumerate(batch):
            t = min(b["feats"][k].shape[0], feat_cap)
            f[i, :t] = b["feats"][k][:t]
            f[i, t:] = 0.0
        feats[k] = f
    feat_mask = bufpool.borrow((len(batch), max_f), np.float32, zero=True)
    for i, b in enumerate(batch):
        feat_mask[i, :min(b["feats"][keys[0]].shape[0], feat_cap)] = 1.0
    out["feats"] = feats
    out["feat_mask"] = feat_mask
    return out
