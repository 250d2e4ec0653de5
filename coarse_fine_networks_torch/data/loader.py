"""Threaded prefetching batch loader (counterpart of
``coarse_fine_networks_tpu/data/loader.py``).

Worker threads load and collate whole batches ahead of the consumer
(Pillow's decode and resize release the interpreter lock) and hand them
over in order.  The device half of the overlap is
:class:`.device_prefetch.DevicePrefetcher`.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Iterator, List

from . import bufpool


class PrefetchLoader:
    """Iterate padded batches from a map-style dataset with worker
    threads.

    ``shuffle`` draws each epoch's order from ``random.Random(seed +
    epoch)``; otherwise ``sort_key`` (a function of the index, e.g. the
    frame count) orders the samples so that batches pad tightly.
    ``shard=(rank, world)`` keeps rank's rows of every global batch of
    ``batch_size`` (which must divide by ``world``; ragged batches are
    dropped).  :meth:`state_dict` / :meth:`load_state_dict` save and restore
    the position inside an epoch; a consumer that holds batches ahead of
    the training loop (the device prefetcher) reports the batches the loop
    has taken with :meth:`consumed`, and the position counts those."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = False,
        num_workers: int = 4,
        prefetch: int = 4,
        drop_last: bool = False,
        seed: int = 0,
        shard: "tuple[int, int] | None" = None,
        sort_key: "Callable[[int], int] | None" = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.shard = shard
        # the epoch of the running iteration and the batches it has yielded
        self._iter_epoch = 0
        self._pos = 0
        self._resume_skip = 0
        # the batches of the running epoch the training loop has taken
        # (counted once a consumer reports them), and the random state
        # each batch's collate started from, by position
        self._taken = 0
        self._counting = False
        self._starts: dict = {}
        self._lock = threading.Lock()
        self.sort_key = sort_key
        if shard is not None:
            rank, world = shard
            if not 0 <= rank < world:
                raise ValueError(f"bad shard {shard}")
            if batch_size % world:
                raise ValueError(f"global batch {batch_size} not divisible "
                                 f"by process count {world}")

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last or self.shard is not None:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        elif self.sort_key is not None:
            idx.sort(key=self.sort_key)
        out = [idx[i:i + self.batch_size]
               for i in range(0, len(idx), self.batch_size)]
        if self.drop_last or self.shard is not None:
            out = [b for b in out if len(b) == self.batch_size]
        if self.shard is not None:
            rank, world = self.shard
            local = self.batch_size // world
            out = [b[rank * local:(rank + 1) * local] for b in out]
        return out

    def _random_state(self) -> dict:
        st = {"random": random.getstate()}
        rng = getattr(self.dataset, "rng", None)
        if rng is not None:
            st["sampler"] = rng.getstate()
        return st

    def consumed(self, n: int = 1) -> None:
        """The training loop took ``n`` more batches of the running epoch:
        from now on :meth:`state_dict`'s position counts taken batches, not
        the ones yielded to a stage that holds them ahead.  Until the first
        report the loader keeps the random states of the last ``prefetch +
        num_workers`` batches yielded, so a stage may hold that many ahead
        before it first reports (or report ``consumed(0)`` first)."""
        self._counting = True
        self._taken += n

    def state_dict(self) -> dict:
        """The input position: the running epoch and the batches consumed
        from it (the shuffle is a function of seed + epoch, so this fixes
        the rest of the order), and the random state the next batch's
        samples are drawn from: the global :mod:`random` module's (the
        transforms') and the dataset's own ``rng`` (the start frames), as
        they stood when that batch's collate began, or now if it has not.
        With one worker a resume therefore draws what an uninterrupted run
        draws, inside an epoch too; with more, the workers' draws
        interleave and the state is approximate."""
        pos = self._taken if self._counting else self._pos
        with self._lock:
            st = self._starts.get(pos) or self._random_state()
        return {"epoch": self._iter_epoch, "pos": pos, **st}

    def load_state_dict(self, sd: dict) -> None:
        """Continue at ``sd``'s position (the next iteration runs its epoch
        from batch ``pos`` on) with its random state."""
        self.epoch = self._iter_epoch = int(sd["epoch"])
        self._resume_skip = self._pos = self._taken = int(sd["pos"])
        if "random" in sd:
            random.setstate(sd["random"])
        rng = getattr(self.dataset, "rng", None)
        if rng is not None and "sampler" in sd:
            rng.setstate(sd["sampler"])

    def __iter__(self) -> Iterator:
        self._iter_epoch = self.epoch
        batches = self._batches()
        self.epoch += 1
        skip, self._resume_skip = self._resume_skip, 0
        batches = batches[skip:]
        self._pos = self._taken = skip
        with self._lock:
            self._starts = {}
        # at most `window` batches are in the loader at once (being
        # collated, queued or waiting for an earlier batch to be yielded);
        # worker threads borrow out of index order by up to one batch each,
        # so the rings need window + num_workers + 2 slots
        window = self.prefetch + self.num_workers
        bs = (self.batch_size if self.shard is None
              else self.batch_size // self.shard[1])
        large = window + self.num_workers + 2
        bufpool.ensure_slots(small=max(large, self.prefetch
                                       + self.num_workers * bs + 2),
                             large=large)
        work: "queue.Queue" = queue.Queue()
        done: "queue.Queue" = queue.Queue()
        for i, b in enumerate(batches):
            work.put((i, b))
        for _ in range(self.num_workers):
            work.put(None)
        stop = threading.Event()
        room = threading.Semaphore(window)

        def worker():
            while not stop.is_set():
                if not room.acquire(timeout=0.1):
                    continue
                item = work.get()
                if item is None:
                    room.release()
                    break
                i, idxs = item
                with self._lock:
                    self._starts[skip + i] = self._random_state()
                try:
                    batch = self.collate_fn([self.dataset[j] for j in idxs])
                except Exception as e:  # noqa: BLE001 — raised in consumer
                    batch = e
                done.put((i, batch))
            done.put(None)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        results = {}
        finished = 0
        next_idx = 0
        try:
            while next_idx < len(batches):
                item = done.get()
                if item is None:
                    finished += 1
                    if finished == self.num_workers and not results:
                        break
                    continue
                i, batch = item
                if isinstance(batch, Exception):
                    raise batch
                results[i] = batch
                while next_idx in results:
                    out = results.pop(next_idx)
                    room.release()
                    next_idx += 1
                    self._pos += 1
                    # a stage ahead of the loop may report its first taken
                    # batch only after this one is yielded: until it does,
                    # keep the starts of the last `window` positions
                    past = (self._taken if self._counting
                            else self._pos - window)
                    with self._lock:  # no state_dict asks for these again
                        for k in [k for k in self._starts if k < past]:
                            del self._starts[k]
                    yield out
        finally:
            # a consumer that stops early: the workers finish the batch in
            # hand and exit
            stop.set()
            for t in threads:
                t.join()
