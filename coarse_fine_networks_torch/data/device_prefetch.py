"""Input/compute overlap: host batches staged on the device ahead of the
step (counterpart of ``coarse_fine_networks_tpu/data/device_prefetch.py``).

A background thread runs ``put_fn`` (the host-to-device copies and the
normalisation of the clips) ``depth`` batches ahead of the consumer.  On the
card it does so on a side CUDA stream: the pooled host buffers are
page-locked (``bufpool.pin_memory``) so the copies are asynchronous, an
event recorded after each batch's work makes the consumer's stream wait for
it, every tensor of the batch is marked as used on the consumer's stream
(``record_stream``) so the allocator does not hand its memory to the side
stream while the step reads it, and the batch's pooled host buffers are
fenced with that event, so their ring hands them out again only once the
copy has read them.  Natively decoded clips arrive on the device already
(made on a loader thread's stream, which that thread synchronised): they
pass through without a copy, marked as used on the side stream, and only
host arrays are fenced.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Tuple

import numpy as np
import torch

from . import bufpool


def _leaves(obj) -> Iterator:
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)
    else:
        yield obj


class DevicePrefetcher:
    """Wrap a host-batch iterable; yield ``put_fn(host_batch)`` results
    prepared ``depth`` batches ahead in a background thread.

    ``device``: where ``put_fn`` puts the batch (the card unless the caller
    asks for the CPU); a CUDA device turns on the side stream, pinned
    buffers and fences described in the module docstring.  Exceptions of ``put_fn`` or of the source reach the consumer
    at the matching ``__next__``.  :attr:`waits` (``waits`` if given) gets,
    per yielded batch, the seconds the consumer waited for it."""

    def __init__(self, source: Iterable, put_fn: Callable[[Any], Any],
                 depth: int = 2, device: "str | torch.device" = "cuda",
                 waits: "List[float] | None" = None):
        self._source = source
        self._put = put_fn
        self._depth = max(1, depth)
        self.device = torch.device(device)
        self.waits: List[float] = [] if waits is None else waits
        # host batches live past the loader's own window: depth in the
        # queue, one staged by the producer, one held by the consumer (the
        # JAX package reserves depth + 1 and leaves out the consumer's)
        bufpool.reserve_extra(self._depth + 2)
        if self.device.type == "cuda":
            bufpool.pin_memory(True)

    def _stage(self, hb, stream):
        """``put_fn(hb)`` on ``stream`` (None: the CPU), and the event that
        marks its end."""
        if stream is None:
            return self._put(hb), None
        for x in _leaves(hb):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                x.record_stream(stream)
        with torch.cuda.stream(stream):
            out = self._put(hb)
            event = torch.cuda.Event()
            event.record(stream)
        bufpool.fence([a for a in _leaves(hb) if isinstance(a, np.ndarray)],
                      event)
        return out, event

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        stream = (torch.cuda.Stream(device=self.device)
                  if self.device.type == "cuda" else None)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            it = iter(self._source)
            try:
                for hb in it:
                    if not put(("ok", self._stage(hb, stream))):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                put(("err", e))
                return
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()  # a loader's threads exit with it
            put(("end", None))

        t = threading.Thread(target=producer, daemon=True,
                             name="device-prefetch")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                kind, item = q.get()
                if kind == "err":
                    raise item
                if kind == "end":
                    return
                self.waits.append(time.perf_counter() - t0)
                out, event = item
                if event is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(event)
                    for x in _leaves(out):
                        if isinstance(x, torch.Tensor) and x.is_cuda:
                            x.record_stream(cur)
                yield out
        finally:
            stop.set()


def overlap_iter(source: Iterable, put_fn: Callable[[Any], Any],
                 depth: int = 2, device: "str | torch.device" = "cuda"
                 ) -> Iterator[Tuple[Any, Any]]:
    """Like :class:`DevicePrefetcher` but yields ``(device_batch,
    host_batch)`` pairs, as the drivers' metrics need."""
    return iter(DevicePrefetcher(source, lambda hb: (put_fn(hb), hb), depth,
                                 device))
