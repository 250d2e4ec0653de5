"""Reusable host buffer rings for the input pipeline (counterpart of
``coarse_fine_networks_tpu/data/bufpool.py``).

Fresh ~10 MB clip and ~100 MB batch arrays every step pay the kernel's
page-fault path each time (glibc returns large frees to the OS), so decode
outputs and collate buffers come from per-(shape, dtype) rings of arrays
that cycle through a fixed number of slots.

Borrow contract: an array from :func:`borrow` is valid until its (shape,
dtype) key has been borrowed ``slots`` more times.  The loader raises the
ring sizes to its in-flight window (:func:`ensure_slots`) and the device
prefetcher by its lookahead (:func:`reserve_extra`).

Two additions for the card: after :func:`pin_memory` ``(True)`` new
buffers are page-locked, so a host-to-device copy from them is
asynchronous; and :func:`fence` ties a buffer to the CUDA event recorded
after its copy, so :func:`borrow` hands that buffer out again only once the
copy has finished reading it.  ``CFN_POOL_SLOTS=n`` sets the base ring size
(the loader's and prefetcher's additions still apply); ``0`` disables
pooling.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Tuple

import numpy as np

_LARGE_BYTES = 32 << 20

# ring-size floors raised by the loader to its in-flight window, and extra
# slots reserved by stages that keep batches alive past it
_MIN_SMALL = [0]
_MIN_LARGE = [0]
_EXTRA = [0]


def ensure_slots(small: int, large: int) -> None:
    """Raise the ring-size floors so each buffer of a consumer's in-flight
    window has its own slot."""
    _MIN_SMALL[0] = max(_MIN_SMALL[0], int(small))
    _MIN_LARGE[0] = max(_MIN_LARGE[0], int(large))


def reserve_extra(n: int) -> None:
    """Reserve ``n`` extra slots in every ring for a stage that holds
    batches beyond the loader's window (the device prefetcher's lookahead)."""
    _EXTRA[0] = max(_EXTRA[0], int(n))


def _default_slots() -> Tuple[int, int]:
    """(large, small) ring sizes; 0 disables pooling."""
    spec = os.environ.get("CFN_POOL_SLOTS")
    if spec is not None and int(spec) <= 0:
        return (0, 0)
    large, small = (8, 64) if spec is None else (int(spec), int(spec))
    return (max(large, _MIN_LARGE[0]) + _EXTRA[0],
            max(small, _MIN_SMALL[0]) + _EXTRA[0])


def _empty(shape, dtype: np.dtype, pinned: bool) -> np.ndarray:
    if not pinned:
        return np.empty(shape, dtype)
    import torch

    t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                    pin_memory=True)
    return t.numpy()  # the array keeps the pinned tensor alive


class ArrayRing:
    """Per-(shape, dtype) rings of reusable numpy buffers."""

    def __init__(self, pinned: bool = False):
        self.pinned = pinned
        self._lock = threading.Lock()
        self._rings: Dict[Tuple, Tuple[List[np.ndarray], List[int]]] = {}
        self._fences: Dict[int, object] = {}

    def borrow(self, shape, dtype, zero: bool = False) -> np.ndarray:
        shape = tuple(int(s) for s in shape)
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        large, small = _default_slots()
        slots = large if nbytes >= _LARGE_BYTES else small
        if slots <= 0:
            return np.zeros(shape, dtype) if zero else np.empty(shape, dtype)
        key = (shape, dtype.str)
        with self._lock:
            bufs, cursor = self._rings.setdefault(key, ([], [0]))
            if len(bufs) < slots:
                buf = _empty(shape, dtype, self.pinned)
                bufs.append(buf)
            else:
                buf = bufs[cursor[0] % len(bufs)]
                cursor[0] += 1
            event = self._fences.pop(id(buf), None)
        if event is not None:
            event.synchronize()  # its copy to the device is still reading
        if zero:
            buf.fill(0)
        return buf

    def fence(self, arrays, event) -> None:
        """Keep each of ``arrays`` (those this ring lent) out of circulation
        until ``event`` (a ``torch.cuda.Event`` recorded after their copy)
        has completed."""
        with self._lock:
            owned = {id(b) for bufs, _ in self._rings.values() for b in bufs}
            for a in arrays:
                if id(a) in owned:
                    self._fences[id(a)] = event

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()
            self._fences.clear()


_POOL = ArrayRing()


def borrow(shape, dtype, zero: bool = False) -> np.ndarray:
    """Borrow a reusable array from the process-wide pool (see the module
    docstring for how long it stays valid)."""
    return _POOL.borrow(shape, dtype, zero=zero)


def fence(arrays, event) -> None:
    """:meth:`ArrayRing.fence` on the process-wide pool."""
    _POOL.fence(arrays, event)


def pin_memory(on: bool) -> None:
    """Allocate the process-wide pool's new buffers page-locked (for
    asynchronous copies to the card) or not."""
    _POOL.pinned = bool(on)


def clear() -> None:
    """Drop all pooled buffers."""
    _POOL.clear()
