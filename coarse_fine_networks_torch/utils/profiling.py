"""Tracing and step timing (counterpart of
``coarse_fine_networks_tpu/utils/profiling.py``; the reference has none, its
only observability is pkbar's wall clock)."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch
from torch.profiler import (ProfilerActivity, profile, schedule,
                            tensorboard_trace_handler)

from .hw import sync


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Trace the body with ``torch.profiler`` (host ops and, where a card
    is present, its kernels and copies) into ``log_dir``: one
    ``*.pt.trace.json`` that TensorBoard's profiler plugin and Perfetto
    read.

    A trace that starts with the traced work loses that work's first
    kernel records, so the profiler first traces and discards a warm-up
    (a synchronised device round trip) and then records the body."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        if cuda:
            torch.zeros(1, device="cuda").add_(1).item()
            torch.cuda.synchronize()
        prof.step()
        yield prof
        if cuda:
            torch.cuda.synchronize()
        prof.step()


class StepTimer:
    """Host-clock step timer with simple statistics: each
    :meth:`measure` ends when its ``result`` is computed (:func:`.hw.sync`),
    or, without one, when every card is idle."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, result=None):
        """Time the body; ``result``: a tensor or a nested structure of
        them, read after the body (a list the body appends its outputs to
        works)."""
        t0 = time.perf_counter()
        yield
        if result is not None:
            sync(result)
        elif torch.cuda.is_available():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def best(self) -> float:
        return min(self.times) if self.times else 0.0
