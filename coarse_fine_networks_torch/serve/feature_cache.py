"""Fine-feature cache in front of the batching video server (counterpart
of ``coarse_fine_networks_tpu/serve/feature_cache.py``).

The fine tower's 7×7 feature banks depend only on the video, and the fine
tower (T_f = 2T frames through the whole X3D trunk) dominates whole-video
cost, so repeat requests for a video skip it.  :class:`FeatureCache` is a
thread-safe byte-bounded LRU keyed by video id; :class:`CachingVideoServer`
runs misses through ``extract``, stores their banks sliced to the true fine
length, and runs every request, hit or miss, through ``fuse``.  A hit is
re-padded to whatever bucket it lands in, with the validity mask carrying
the true extent.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .scheduler import InferenceRequest, VideoServer, _as_clip, _bucket_up

FeatDict = Dict[str, np.ndarray]


class FeatureCache:
    """Thread-safe byte-bounded LRU of per-video fine-feature banks: dicts of
    ``(t_f, 7, 7, C)`` float32 arrays stored sliced to the true fine
    length."""

    def __init__(self, capacity_bytes: int = 1 << 30):
        self.capacity = capacity_bytes
        self._data: "collections.OrderedDict[str, Tuple[FeatDict, int]]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _nbytes(feats: FeatDict) -> int:
        return sum(v.nbytes for v in feats.values())

    def get(self, video_id: str) -> Optional[Tuple[FeatDict, int]]:
        """Return ``(feats, true_fine_len)`` and refresh LRU order."""
        with self._lock:
            entry = self._data.get(video_id)
            if entry is None:
                self.misses += 1
                return None
            self._data.move_to_end(video_id)
            self.hits += 1
            return entry

    def put(self, video_id: str, feats: FeatDict, fine_len: int) -> None:
        size = self._nbytes(feats)
        if size > self.capacity:
            return  # larger than the whole cache: never admitted
        with self._lock:
            old = self._data.pop(video_id, None)
            if old is not None:
                self._bytes -= self._nbytes(old[0])
            self._data[video_id] = (feats, fine_len)
            self._bytes += size
            while self._bytes > self.capacity:
                _, (ev, _) = self._data.popitem(last=False)
                self._bytes -= self._nbytes(ev)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    @property
    def nbytes(self) -> int:
        return self._bytes

    FEATURE_KEYS = ("layer1", "layer2", "layer3", "layer4", "conv5")

    def preload_dir(self, feat_dir: str, keys=FEATURE_KEYS,
                    max_videos: Optional[int] = None) -> int:
        """Warm the cache from an extraction bank ``<feat_dir>/<key>/<vid>``:
        the port's ``<vid>.npy`` (float32 ``(T, 7, 7, C)``, as
        :func:`..train.extract_driver.run` writes it) or the reference's
        ``torch.save`` file ``<vid>`` (``(1, C, T, 7, 7)``, loaded with
        ``weights_only`` and transposed).  Videos are admitted in sorted
        order, at most ``max_videos``; LRU eviction applies once the
        capacity is reached, so the last loaded survive.  Returns the
        number of videos admitted."""
        d0 = os.path.join(feat_dir, keys[0])
        vids = sorted({f.rsplit(".", 1)[0] if "." in f else f
                       for f in os.listdir(d0)})
        if max_videos is not None:
            vids = vids[:max_videos]
        for vid in vids:
            feats = {}
            for k in keys:
                path = os.path.join(feat_dir, k, vid)
                if os.path.exists(path + ".npy"):
                    f = np.load(path + ".npy")
                else:
                    f = torch.load(path, map_location="cpu",
                                   weights_only=True)
                    f = f.squeeze(0).permute(1, 2, 3, 0).numpy()
                feats[k] = np.ascontiguousarray(f, np.float32)
            self.put(vid, feats, feats[keys[0]].shape[0])
        return len(vids)


class CachingVideoServer(VideoServer):
    """:class:`VideoServer` with a fine-feature cache between the streams.

    Args:
      extract_fn: ``fine_clips (B, T_f, H, W, 3) -> feats`` on its device,
        e.g. :meth:`..models.CoarseFinePipeline.extract`.
      fuse_fn: ``(clips, feats, feat_mask, meta, label_len) -> probs``,
        e.g. :meth:`..models.CoarseFinePipeline.fuse`.
      cache: a :class:`FeatureCache`; a fresh 1 GiB one by default.

    ``submit(..., video_id=...)`` caches that request's banks; a hit may omit
    ``fine_clips`` entirely.  With a list of ``devices`` (data-parallel
    serving, :mod:`.scheduler`) ``extract_fn`` and ``fuse_fn`` are each one function
    for every device or a sequence of replicas, and both programs split
    their rows over the devices."""

    def __init__(self, extract_fn, fuse_fn,
                 cache: Optional[FeatureCache] = None, **kw):
        super().__init__(apply_fn=None, **kw)
        self._extract = self._replicas(extract_fn)
        self._fuse = self._replicas(fuse_fn)
        self.cache = cache if cache is not None else FeatureCache()

    def submit(self, clips: np.ndarray,
               fine_clips: Optional[np.ndarray] = None,
               meta: Optional[np.ndarray] = None,
               video_id: Optional[str] = None,
               priority: int = 0):
        clips = _as_clip(clips, "clips")
        cached = self.cache.get(video_id) if video_id is not None else None
        if cached is None:
            if fine_clips is None:
                raise ValueError(
                    f"video {video_id!r} not cached: fine_clips required")
            fine_clips = _as_clip(fine_clips, "fine_clips")
        req = InferenceRequest(clips, fine_clips,
                               None if meta is None
                               else np.asarray(meta, np.int32),
                               priority=priority)
        req.video_id = video_id
        req.cached = cached
        return self._enqueue(req)

    def _bucket_key(self, req: InferenceRequest) -> Tuple[int, ...]:
        # hits have no fine pixels: spatial dims 0 keep them out of miss
        # batches (whose extract needs a real (fh, fw))
        tf = (req.cached[1] if req.cached is not None
              else req.fine_clips.shape[0])
        fh, fw = ((0, 0) if req.cached is not None
                  else req.fine_clips.shape[1:3])
        return (_bucket_up(req.clips.shape[0], self.bucket_multiple),
                _bucket_up(tf, self.bucket_multiple),
                req.clips.shape[1], req.clips.shape[2], fh, fw)

    def _run_batch(self, key, reqs):
        t_pad, tf_pad, h, w, fh, fw = key
        b = len(reqs)
        with torch.inference_mode():
            miss = [i for i, r in enumerate(reqs) if r.cached is None]
            miss_feats = None
            if miss:
                fine = np.zeros((len(miss), tf_pad, fh, fw, 3), np.float32)
                for j, i in enumerate(miss):
                    tf = reqs[i].fine_clips.shape[0]
                    fine[j, :tf] = reqs[i].fine_clips
                miss_feats = self._run_rows(self._extract, (fine,),
                                            lambda fn, dev, x: fn(x[0]))
                for j, i in enumerate(miss):
                    r = reqs[i]
                    if r.video_id is not None:
                        tf = r.fine_clips.shape[0]
                        self.cache.put(
                            r.video_id,
                            {k: v[j, :tf].copy()
                             for k, v in miss_feats.items()}, tf)

            # the fused-feature batch: every tap (b, tf_pad, 7, 7, C)
            protos = (miss_feats if miss_feats is not None
                      else reqs[0].cached[0])
            mi = {i: j for j, i in enumerate(miss)}
            feats = {}
            for k, proto in protos.items():
                fk = np.zeros((b, tf_pad) + proto.shape[-3:], np.float32)
                for i, r in enumerate(reqs):
                    if r.cached is not None:
                        fk[i, :r.cached[1]] = r.cached[0][k]
                    else:
                        fk[i] = miss_feats[k][mi[i]]
                feats[k] = fk

            clips = np.zeros((b, t_pad, h, w, 3), np.float32)
            feat_mask = np.zeros((b, tf_pad), np.float32)
            meta = np.zeros((b, 4), np.int32)
            for i, r in enumerate(reqs):
                tf = (r.cached[1] if r.cached is not None
                      else r.fine_clips.shape[0])
                t = r.clips.shape[0]
                clips[i, :t] = r.clips
                feat_mask[i, :tf] = 1.0
                meta[i] = (r.meta if r.meta is not None
                           else np.asarray([0, t, tf, 1], np.int32))
            keys = sorted(feats)
            probs = self._run_rows(
                self._fuse, [clips, feat_mask, meta] + [feats[k] for k in keys],
                lambda fn, dev, x: fn(x[0], dict(zip(keys, x[3:])), x[1],
                                      x[2], 4 * t_pad))
        self._finish(reqs, probs)
