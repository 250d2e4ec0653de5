"""Continuous-batching video inference server (counterpart of
``coarse_fine_networks_tpu/serve/scheduler.py``).

Requests carry whole videos of any length; the scheduler pads each to a
geometric length bucket (``multiple·2^k``), groups same-bucket requests up
to ``max_batch`` within a ``max_wait_ms`` deadline, and runs the model once
per batch on its device.  Each result is sliced back to the request's true
frame count, and padded fine frames are masked out of the fusion.

Serving semantics:

* **bounded queue / backpressure**: ``submit`` raises
  :class:`ServerOverloadedError` once ``max_queue`` requests are pending;
* **per-request timeout**: requests older than ``request_timeout_s`` fail
  with ``TimeoutError``; the idle wait is bounded by the timeout, so expiry
  runs on time even when ``max_wait_ms`` is long;
* **cancellation**: ``Future.cancel()`` before the batch launches removes the
  request from its batch;
* **error isolation**: an exception in one batch fails only that batch's
  futures; the scheduler keeps serving;
* **priority classes**: higher priority schedules first, with time-based
  aging (``priority_aging_s``) so background traffic is never starved.

Buckets key on both temporal lengths and the spatial sizes of both streams,
so mixed-resolution traffic is never fused into one batch.

**Data-parallel serving** (the JAX server's mesh): given a list of
``devices``, the server runs one replica of the model function on each device; a batch is
padded to a multiple of the device count with copies of its row 0, its
rows split in equal contiguous parts, one part a replica (each launched
before any result is read, so the devices run together), and the results
are put back in row order and the padding sliced away
(:func:`_shard_rows`, the JAX package's ``_shard_rows``).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class ServerOverloadedError(RuntimeError):
    """Raised by ``submit`` when the pending-request queue is full."""


def _bucket_up(n: int, multiple: int) -> int:
    m = multiple
    while m < n:
        m *= 2
    return m


def _shard_rows(arrays: Sequence[np.ndarray], n: int
                ) -> Tuple[List[List[np.ndarray]], int]:
    """Each of ``n`` devices' contiguous rows of host batch ``arrays``,
    the batch first padded up to a multiple of ``n`` with copies of row 0
    (benign inputs whose outputs are sliced away); returns the per-device
    lists and the padded batch size."""
    b = arrays[0].shape[0]
    pb = -(-b // n) * n
    parts: List[List[np.ndarray]] = [[] for _ in range(n)]
    for a in arrays:
        if pb != b:
            a = np.concatenate([a, np.repeat(a[:1], pb - b, axis=0)], axis=0)
        for i, p in enumerate(np.split(a, n)):
            parts[i].append(p)
    return parts, pb


def _host(out):
    """A model output (a tensor or a dict of tensors) as f32 numpy."""
    if isinstance(out, dict):
        return {k: v.float().cpu().numpy() for k, v in out.items()}
    return out.float().cpu().numpy()


def _rows_back(outs: list, b: int):
    """The replicas' outputs concatenated in row order, cut to ``b``
    rows."""
    if isinstance(outs[0], dict):
        return {k: np.concatenate([o[k] for o in outs])[:b] for k in outs[0]}
    return np.concatenate(outs)[:b]


@dataclasses.dataclass
class InferenceRequest:
    clips: np.ndarray        # (T, H, W, 3) float32: coarse-stream frames
    fine_clips: Optional[np.ndarray]  # (T_f, H', W', 3) float32
    meta: Optional[np.ndarray] = None   # (4,) int32; default whole video
    priority: int = 0        # higher preempts; aging prevents starvation
    future: Future = dataclasses.field(default_factory=Future)
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)
    # set by serve.feature_cache.CachingVideoServer
    video_id: Optional[str] = None
    cached: Optional[tuple] = None      # (feats dict, true fine length)

    @property
    def label_len(self) -> int:
        return 4 * self.clips.shape[0]


def _as_clip(a, name: str) -> np.ndarray:
    a = np.asarray(a, np.float32)
    if a.ndim != 4 or a.shape[-1] != 3:
        raise ValueError(f"{name} must be (T, H, W, 3), got {a.shape}")
    return a


class VideoServer:
    """Batching scheduler over a whole-video apply function.

    Args:
      apply_fn: ``(clips, fine_clips, meta, label_len, fine_mask) -> probs``
        on tensors of its device (e.g. a
        :class:`..models.CoarseFinePipeline`);
        called under ``torch.inference_mode()``.
      max_batch: upper bound on requests fused into one call.
      max_wait_ms: how long a non-full batch is held open for same-bucket
        stragglers.
      bucket_multiple: base of the geometric padding buckets.
      max_queue: pending-request bound (backpressure).
      request_timeout_s: if set, requests that wait longer fail with
        ``TimeoutError``.
      priority_aging_s: seconds of waiting worth one priority level.
      devices: where batches are placed: ``"cuda"`` unless the caller
        asks for the CPU; a list of devices serves data-parallel over them
        (module docstring), ``apply_fn`` then one function for every
        device or a sequence of replicas, one a device.
    """

    def __init__(self, apply_fn, max_batch: int = 4,
                 max_wait_ms: float = 5.0, bucket_multiple: int = 16,
                 max_queue: int = 256,
                 request_timeout_s: Optional[float] = None,
                 priority_aging_s: float = 1.0,
                 devices: str | torch.device | Sequence = "cuda"):
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self._apply = self._replicas(apply_fn)
        self.priority_aging = priority_aging_s
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.bucket_multiple = bucket_multiple
        self.max_queue = max_queue
        self.request_timeout = request_timeout_s
        self._buckets: Dict[Tuple[int, ...], collections.deque] = {}
        self._pending = 0
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.batches_run = 0
        self.batch_sizes: list = []
        self.timeouts = 0
        self.cancelled = 0

    # -- public API ----------------------------------------------------------

    def start(self) -> "VideoServer":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def submit(self, clips: np.ndarray, fine_clips: np.ndarray,
               meta: Optional[np.ndarray] = None,
               priority: int = 0) -> Future:
        """Queue one whole-video request; the Future resolves to per-frame
        class probabilities ``(4*T, n_classes)`` float32.

        Raises :class:`ServerOverloadedError` when ``max_queue`` requests
        are already pending, and ``ValueError`` on malformed inputs."""
        req = InferenceRequest(_as_clip(clips, "clips"),
                               _as_clip(fine_clips, "fine_clips"),
                               None if meta is None
                               else np.asarray(meta, np.int32),
                               priority=priority)
        return self._enqueue(req)

    # -- internals -----------------------------------------------------------

    def _enqueue(self, req: InferenceRequest) -> Future:
        key = self._bucket_key(req)
        with self._lock:
            if self._pending >= self.max_queue:
                raise ServerOverloadedError(
                    f"{self._pending} requests pending (max_queue="
                    f"{self.max_queue})")
            self._buckets.setdefault(key, collections.deque()).append(req)
            self._pending += 1
        self._wake.set()
        return req.future

    def _bucket_key(self, req: InferenceRequest) -> Tuple[int, ...]:
        """Temporal buckets of both streams + exact spatial sizes of both
        streams: only requests that pad to one batch shape share a key."""
        return (_bucket_up(req.clips.shape[0], self.bucket_multiple),
                _bucket_up(req.fine_clips.shape[0], self.bucket_multiple),
                req.clips.shape[1], req.clips.shape[2],
                req.fine_clips.shape[1], req.fine_clips.shape[2])

    def _expire_and_prune(self):
        """Drop timed-out and cancelled requests from every bucket; fail the
        timed-out ones.  Called with the lock held."""
        now = time.monotonic()
        for dq in self._buckets.values():
            kept = []
            for r in dq:
                if r.future.cancelled():
                    self.cancelled += 1
                    self._pending -= 1
                    continue
                if (self.request_timeout is not None
                        and now - r.enqueued_at > self.request_timeout):
                    if r.future.set_running_or_notify_cancel():
                        r.future.set_exception(TimeoutError(
                            f"request waited > {self.request_timeout}s"))
                        self.timeouts += 1
                    else:
                        self.cancelled += 1
                    self._pending -= 1
                    continue
                kept.append(r)
            dq.clear()
            dq.extend(kept)

    def _take_batch(self):
        """Pick the bucket whose head request scores highest
        (``priority + waited/priority_aging_s``) and take up to
        ``max_batch`` runnable requests from it."""
        with self._lock:
            self._expire_and_prune()
            now = time.monotonic()
            best_key, best_score, best_age = None, None, None
            for key, dq in self._buckets.items():
                if not dq:
                    continue
                r = dq[0]
                score = r.priority + (now - r.enqueued_at) / max(
                    self.priority_aging, 1e-6)
                if best_score is None or score > best_score:
                    best_key, best_score = key, score
                    best_age = r.enqueued_at
            if best_key is None:
                return None, []
            dq = self._buckets[best_key]
            if len(dq) < self.max_batch and now - best_age < self.max_wait:
                return None, []   # hold the batch open for stragglers
            out = []
            while dq and len(out) < self.max_batch:
                r = dq.popleft()
                self._pending -= 1
                # PENDING -> RUNNING; False if cancelled meanwhile
                if r.future.set_running_or_notify_cancel():
                    out.append(r)
                else:
                    self.cancelled += 1
            return best_key, out

    def _replicas(self, fn) -> Optional[list]:
        """One function a device: ``fn`` itself for each, or the given
        replicas."""
        if fn is None:
            return None
        fns = list(fn) if isinstance(fn, (list, tuple)) else \
            [fn] * len(self.devices)
        if len(fns) != len(self.devices):
            raise ValueError(f"{len(fns)} replicas for "
                             f"{len(self.devices)} devices")
        return fns

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _run_rows(self, fns: list, arrays: Sequence[np.ndarray],
                  call: Callable):
        """``call(fn, device, tensors)`` on each device's rows of host batch
        ``arrays`` (:func:`_shard_rows`; on one device the whole batch),
        every replica launched before any result is read; returns the
        outputs as f32 numpy in row order."""
        if len(self.devices) == 1:
            return _host(call(fns[0], self.device,
                              [self._tensor(a) for a in arrays]))
        parts, _ = _shard_rows(arrays, len(self.devices))
        outs = [call(fn, dev, [torch.from_numpy(a).to(dev) for a in part])
                for fn, dev, part in zip(fns, self.devices, parts)]
        return _rows_back([_host(o) for o in outs], arrays[0].shape[0])

    def _run_batch(self, key, reqs):
        t_pad, tf_pad, h, w, fh, fw = key
        b = len(reqs)
        clips = np.zeros((b, t_pad, h, w, 3), np.float32)
        fine = np.zeros((b, tf_pad, fh, fw, 3), np.float32)
        fine_mask = np.zeros((b, tf_pad), np.float32)
        meta = np.zeros((b, 4), np.int32)
        for i, r in enumerate(reqs):
            t, tf = r.clips.shape[0], r.fine_clips.shape[0]
            clips[i, :t] = r.clips
            fine[i, :tf] = r.fine_clips
            fine_mask[i, :tf] = 1.0
            # nf is the TRUE fine frame count
            meta[i] = (r.meta if r.meta is not None
                       else np.asarray([0, t, tf, 1], np.int32))
        with torch.inference_mode():
            probs = self._run_rows(
                self._apply, (clips, fine, meta, fine_mask),
                lambda fn, dev, x: fn(x[0], x[1], x[2], 4 * t_pad,
                                      fine_mask=x[3]))
        self._finish(reqs, probs)

    def _finish(self, reqs, probs: np.ndarray) -> None:
        self.batches_run += 1
        self.batch_sizes.append(len(reqs))
        for i, r in enumerate(reqs):
            r.future.set_result(probs[i, : r.label_len])

    def _idle_wait(self) -> float:
        wait = self.max_wait / 2 or 0.002
        if self.request_timeout is not None:
            wait = min(wait, self.request_timeout / 2)
        return wait

    def _loop(self):
        while not self._stop.is_set():
            key, reqs = self._take_batch()
            if not reqs:
                self._wake.wait(timeout=self._idle_wait())
                self._wake.clear()
                continue
            try:
                self._run_batch(key, reqs)
            except Exception as e:  # isolate: fail this batch, keep serving
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
