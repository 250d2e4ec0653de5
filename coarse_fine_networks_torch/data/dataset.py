"""Charades clip datasets and padded-batch collation (counterpart of
``coarse_fine_networks_tpu/data/dataset.py``).

Clips come out channels-last uint8 ``(N_crops, T, H, W, 3)`` with a per-clip
flip flag, normalised later on the device (:func:`.transforms
.device_normalize`); labels are time-major ``(T_l, C)``.  The collates pad
the time axes up to fixed multiples, or geometric buckets, so that the
steps see few shapes; masks carry the true lengths.

Frames are decoded with Pillow.  The JAX package's native C++ decoder and
its ``.cfnpack`` containers are not ported: ``decode_backend="native"`` and
``pack_dir`` raise rather than decode another way.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from . import bufpool
from .annotations import make_dataset
from .transforms import RandomHorizontalFlip

FEAT_CAP = 128  # fine-feature temporal cap (charades_coarse_fineFEAT.py:210)

_NATIVE = ("the native decoder and .cfnpack packs are not ported "
           "(ROADMAP.md, queue 1: the host data plane's native half)")


def load_frame(root: str, vid: str, index: int) -> Optional[Image.Image]:
    """Frame ``root/<vid>/<vid>-%06d.jpg`` as RGB, or None if absent."""
    path = os.path.join(root, vid, f"{vid}-{index:06d}.jpg")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        with Image.open(f) as img:
            return img.convert("RGB")


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
    ):
        if decode_backend not in ("auto", "pil"):
            raise NotImplementedError(f"decode_backend={decode_backend!r}: "
                                      f"{_NATIVE}")
        if pack_dir:
            raise NotImplementedError(f"pack_dir: {_NATIVE}")
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

        imgs = load_clip_frames(self.root, vid, start_f, frames, stride_f)
        label = label[start_f - 1:start_f - 1 + frames]
        if self.task == "class":
            label = label.max(axis=0)
        flip = False
        if self.spatial_transform is not None:
            self.spatial_transform.randomize_parameters(self.crop_size)
            for t in getattr(self.spatial_transform, "transforms",
                             [self.spatial_transform]):
                if isinstance(t, RandomHorizontalFlip) and t.deferred:
                    flip = t.flipped
            imgs = [self.spatial_transform(img) for img in imgs]
        arr = np.stack([np.asarray(im, np.uint8) for im in imgs], axis=0)

        if self.split == "testing":
            if self.task == "class":
                tclip = self.frames // self.gamma_tau
                step = (arr.shape[0] - 1 - tclip) // max(self.crops - 1, 1)
                if step <= 0:
                    clips = np.stack([arr[:tclip]] * self.crops, 0)
                else:
                    clips = np.stack([arr[i:i + tclip] for i in
                                      range(0, step * self.crops, step)], 0)
            else:
                tclip = frames // self.gamma_tau
                clips = np.stack([arr[i::self.crops][:tclip]
                                  for i in range(self.crops)], 0)
                label = label[:tclip * self.gamma_tau]
        else:
            clips = arr[None]

        meta = np.asarray([start_f // self.gamma_tau,
                           frames // self.gamma_tau, nf // self.gamma_tau,
                           stride_f // self.gamma_tau], np.int32)
        sample = {"clips": clips, "label": label.astype(np.float32),
                  "vid": vid, "meta": meta, "dur": float(dur), "flip": flip}
        if self.fine_feat_dir is not None:
            sample["feats"] = self._load_feats(vid)
        return sample


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
    n, h, w = batch[0]["clips"].shape[0], *batch[0]["clips"].shape[2:4]
    c = batch[0]["label"].shape[-1]

    # pooled buffers: only the padded tails are re-zeroed
    clips = bufpool.borrow((len(batch), n, max_t, h, w, 3), np.uint8)
    labels = bufpool.borrow((len(batch), max_l, c), np.float32)
    masks = bufpool.borrow((len(batch), max_l), np.float32, zero=True)
    clip_mask = bufpool.borrow((len(batch), max_t), np.float32, zero=True)
    for i, b in enumerate(batch):
        t = b["clips"].shape[1]
        clips[i, :, :t] = b["clips"]
        clips[i, :, t:] = 0
        clip_mask[i, :t] = 1.0
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
