"""Multi-model routing in front of the video servers (counterpart of
``coarse_fine_networks_tpu/serve/router.py``).

One card serves several model variants at once (fusion heads under A/B
test, an S/M/XL ladder, a canary of a retrained coarse stream): each
variant lives in its own :class:`.scheduler.VideoServer` (its own queue and
scheduler thread), and the router is the one submission surface in front
of them:

* **aliases**: stable client-facing names over versioned registrations
  (``alias("prod", "cfn-m-v7")``); re-pointing an alias is an atomic
  rollout;
* **canary splits**: ``canary(name, canary_name, fraction)`` sends a
  deterministic ``fraction`` of ``name``'s traffic to the canary, keyed on
  ``video_id`` (sha1, as in the JAX package, so a video lands on the same
  variant in both); requests without a video id spread by a submission
  counter;
* **draining stop**: ``stop()`` refuses new work and joins every
  scheduler thread; ``stats()`` gives each variant's queue, batch and
  cache health.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
from concurrent.futures import Future
from typing import Dict, Optional

from .scheduler import VideoServer


class UnknownModelError(KeyError):
    """Raised by :meth:`ModelRouter.submit` for an unregistered model name."""


def _split_key(video_id: Optional[str], counter: int) -> float:
    """Deterministic [0, 1) traffic-split coordinate: a video hashes stably,
    so it never flaps between variants; anonymous requests round-robin."""
    if video_id is not None:
        h = hashlib.sha1(video_id.encode()).digest()
        return int.from_bytes(h[:8], "big") / 2**64
    return (counter % 1000) / 1000.0


class ModelRouter:
    """Named-model front door over per-variant :class:`VideoServer`\\ s."""

    def __init__(self):
        self._servers: Dict[str, VideoServer] = {}
        self._aliases: Dict[str, str] = {}
        self._canaries: Dict[str, tuple] = {}  # name -> (canary_name, frac)
        self._default: Optional[str] = None
        self._lock = threading.Lock()
        self._counter = itertools.count()
        self._started = False
        self._stopped = False

    # -- registry ------------------------------------------------------------

    def register(self, name: str, server: VideoServer,
                 default: bool = False) -> "ModelRouter":
        """Add a variant; the first one registered (or any with
        ``default``) serves requests that name no model.  A router already
        started starts the new server."""
        with self._lock:
            if name in self._servers:
                raise ValueError(f"model {name!r} already registered")
            self._servers[name] = server
            if default or self._default is None:
                self._default = name
            if self._started:
                server.start()
        return self

    def alias(self, alias: str, target: str) -> None:
        """Point a client-facing name at a registration; re-aliasing
        switches traffic without touching batches in flight."""
        with self._lock:
            if target not in self._servers:
                raise UnknownModelError(target)
            self._aliases[alias] = target

    def canary(self, name: str, canary_name: str, fraction: float) -> None:
        """Route ``fraction`` of ``name``'s traffic to ``canary_name``,
        keyed deterministically on ``video_id``; ``fraction=0`` clears."""
        with self._lock:
            if name not in self._servers:
                raise UnknownModelError(name)
            if fraction <= 0.0:
                self._canaries.pop(name, None)
                return
            if canary_name not in self._servers:
                raise UnknownModelError(canary_name)
            self._canaries[name] = (canary_name, min(fraction, 1.0))

    def resolve(self, model: Optional[str],
                video_id: Optional[str] = None) -> str:
        """The variant a request lands on (alias, then canary)."""
        name = model or self._default
        if name is None:
            raise UnknownModelError("no models registered")
        name = self._aliases.get(name, name)
        if name not in self._servers:
            raise UnknownModelError(name)
        split = self._canaries.get(name)
        if split is not None:
            canary_name, frac = split
            if _split_key(video_id, next(self._counter)) < frac:
                return canary_name
        return name

    @property
    def models(self):
        return sorted(self._servers)

    @property
    def stopped(self) -> bool:
        return self._stopped

    # -- serving -------------------------------------------------------------

    def start(self) -> "ModelRouter":
        with self._lock:
            if not self._started:
                for s in self._servers.values():
                    s.start()
                self._started = True
        return self

    def stop(self) -> None:
        """Draining stop: refuse new work, then join every scheduler."""
        with self._lock:
            self._stopped = True
            servers = list(self._servers.values())
        for s in servers:
            s.stop()

    def submit(self, clips, fine_clips=None, meta=None,
               model: Optional[str] = None, **kw) -> Future:
        """Route one whole-video request.  Extra keywords (``video_id`` for
        a :class:`.feature_cache.CachingVideoServer`, ``priority``) pass
        through to the variant's ``submit``, which rejects unknown ones."""
        if self._stopped:
            raise RuntimeError("router stopped")
        name = self.resolve(model, kw.get("video_id"))
        return self._servers[name].submit(clips, fine_clips, meta=meta, **kw)

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per variant: pending requests, batches run, the mean batch,
        timeouts and cancellations, and the feature cache's entries, bytes,
        hits, misses and evictions where it has one."""
        out = {}
        for name, s in self._servers.items():
            d = {
                "pending": s._pending,
                "batches_run": s.batches_run,
                "mean_batch": (sum(s.batch_sizes) / len(s.batch_sizes)
                               if s.batch_sizes else 0.0),
                "timeouts": s.timeouts,
                "cancelled": s.cancelled,
            }
            cache = getattr(s, "cache", None)
            if cache is not None:
                d.update(cache_entries=len(cache), cache_bytes=cache.nbytes,
                         cache_hits=cache.hits, cache_misses=cache.misses,
                         cache_evictions=cache.evictions)
            out[name] = d
        return out
