"""The card's peaks, a barrier a timed loop can trust, utilization against
the peaks, the kernels' build directory, and a count of the work a program
does (counterpart of ``coarse_fine_networks_tpu/utils/hw.py``).

Peaks are the published per-card figures (dense bf16 tensor-core FLOP/s,
f32 FLOP/s outside the tensor cores, HBM bytes/s) at the card's full power
limit.  A card the table does not name gets the H100 SXM's figures,
flagged ``known=False`` with its own name, so a report still runs and says
so.

:func:`program_costs` is the counterpart of ``compiled_costs``: XLA counts a
compiled program; here the program is run once and what it executes is
counted.  Library ops are counted by a ``TorchDispatchMode``: FLOPs by the
formulas ``torch.utils.flop_counter`` registers (products and convolutions;
elementwise work counts no FLOPs), bytes as each op's tensor inputs plus
outputs (no reuse between ops; views and allocations move none).  A
hand-written kernel's wrapper, decorated with :func:`kernel_work`, counts
the work of the function it computes, from its formula beside it in
``ops/`` (the formula the kernel's roofline bound uses), and nothing that
runs inside it: so its plain version on the CPU and its kernel on the card
count the same.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
from pathlib import Path
from typing import Callable, Dict, NamedTuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry


class ChipPeaks(NamedTuple):
    name: str
    flops_bf16: float      # dense bf16 tensor-core FLOP/s
    hbm_bw: float          # HBM bytes/s
    known: bool
    flops_f32: float       # f32 FLOP/s outside the tensor cores


# torch.cuda.get_device_name substring -> peaks (NVIDIA's H100 data sheet,
# SXM part, dense, at 700 W)
H100_SXM = ChipPeaks("H100 SXM", 989e12, 3.35e12, True, 67e12)
_PEAKS: Dict[str, ChipPeaks] = {"h100 80gb hbm3": H100_SXM}


def peaks_for_name(name: str) -> ChipPeaks:
    """The peaks of the card ``torch.cuda.get_device_name`` calls ``name``;
    an unknown name gets the H100 SXM's figures, ``known=False``."""
    low = name.lower()
    for sub, peaks in _PEAKS.items():
        if sub in low:
            return peaks
    return H100_SXM._replace(name=f"unknown({name})->H100-SXM-assumed",
                             known=False)


def chip_peaks(device=None) -> ChipPeaks:
    """The peaks of CUDA ``device`` (default: the current one).  A CPU
    device is not a card and raises."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"chip_peaks: {device} is not a CUDA device")
    return peaks_for_name(torch.cuda.get_device_name(device))


def sync(x):
    """Wait until the tensors of the nested structure ``x`` are computed.

    Each CUDA device that holds one of them is synchronised, then one
    element of the first is read to the host: the read goes through the
    device's queue, so it is a barrier whatever ran before it.  Returns
    ``x``."""
    leaves = [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]
    for dev in {t.device for t in leaves if t.is_cuda}:
        torch.cuda.synchronize(dev)
    if leaves and leaves[0].numel():
        leaves[0].reshape(-1)[0].item()
    return x


def utilization(flops: float, bytes_moved: float, step_seconds: float,
                device=None) -> Dict[str, float]:
    """MFU (against the dense bf16 peak) and the HBM bandwidth fraction of
    one executed program on CUDA ``device``."""
    peaks = chip_peaks(device)
    if step_seconds <= 0:
        return {"mfu": 0.0, "hbm_bw_util": 0.0, "chip": peaks.name}
    return {
        "mfu": flops / step_seconds / peaks.flops_bf16,
        "hbm_bw_util": bytes_moved / step_seconds / peaks.hbm_bw,
        "chip": peaks.name,
    }


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """The directory the hand-written kernels are built into and loaded
    from (``ops/_build.py``: a library is rebuilt only when its source,
    headers or flags change), moved to ``cache_dir`` where given; returns
    it.  The default, ``coarse_fine_networks_torch/_build/``, is
    gitignored."""
    from ..ops import _build

    if cache_dir is not None:
        _build.BUILD_DIR = Path(cache_dir).resolve()
    return str(_build.BUILD_DIR)


# ---- the work a program does ------------------------------------------------

class Work(NamedTuple):
    """A hand-written kernel's work: the bytes its function must move (each
    input read once, each output written once), its products' FLOPs (the
    count ``torch.utils.flop_counter`` gives the same products), and its
    other arithmetic (elementwise: scale, bias, relu, masks, resampling).
    Its roofline bound takes ``ops``, both kinds together."""
    bytes: int
    flops: int
    other: int = 0

    @property
    def ops(self) -> int:
        return self.flops + self.other


# ops that touch no element: allocations, metadata and views (most views
# are found by ``OpOverload.is_view``; ``_unsafe_view`` is a view that does
# not say so)
_NO_DATA = {torch.ops.aten._unsafe_view.default,
            torch.ops.aten.empty.memory_format,
            torch.ops.aten.empty_strided.default,
            torch.ops.aten.empty_like.default,
            torch.ops.aten.new_empty.default,
            torch.ops.aten.new_empty_strided.default,
            torch.ops.aten.resize_.default,
            torch.ops.aten.set_.source_Storage_storage_offset,
            torch.ops.prim.device.default}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Costs(TorchDispatchMode):
    """The counter :func:`program_costs` runs a program under.  Autograd
    carries the dispatch-mode stack to the thread it runs a backward on, so
    the kernels' reports find this counter there too."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: Dict[str, list] = collections.defaultdict(
            lambda: [0, 0, 0])
        self._inside: Dict[int, int] = collections.defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (not self._inside[threading.get_ident()] and not func.is_view
                and func not in _NO_DATA):
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    @contextlib.contextmanager
    def kernel(self, name: str, work: Callable[..., Work], args, kwargs):
        """Inside: no op is counted (the kernel's plain version, the
        wrapper's allocations).  After: the kernel's ``work`` of its
        arguments and output."""
        tid = threading.get_ident()
        self._inside[tid] += 1
        box = []
        try:
            yield box
        finally:
            self._inside[tid] -= 1
        w = work(box[0], *args, **kwargs)
        self.flops += w.flops
        self.bytes += w.bytes
        row = self.kernels[name]
        row[0] += 1
        row[1] += w.flops
        row[2] += w.bytes


def _counter():
    """The innermost :class:`_Costs` on this thread's dispatch-mode stack,
    not inside one of its kernels, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _Costs):
            return None if mode._inside[threading.get_ident()] else mode
    return None


def kernel_work(work: Callable[..., Work]):
    """Decorate a hand-written kernel's wrapper: under
    :func:`program_costs` a call counts ``work(output, *args, **kwargs)``
    (a :class:`Work`) and nothing it runs.  Elsewhere the wrapper runs as
    it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            mode = _counter()
            if mode is None:
                return fn(*args, **kwargs)
            with mode.kernel(fn.__name__, work, args, kwargs) as box:
                box.append(fn(*args, **kwargs))
            return box[0]
        return counted
    return wrap


def program_costs(fn, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once and count its work: ``{"flops",
    "bytes"}`` over everything it executes, its backward included when it
    calls one, and ``kernels``: each hand-written kernel's ``[calls,
    flops, bytes]``.  Library ops count the FLOPs of their products and
    convolutions (``torch.utils.flop_counter``'s formulas; no elementwise
    FLOPs) and each op's tensor inputs plus outputs as bytes; a kernel's
    wrapper counts its function's :class:`Work`."""
    with _Costs() as mode:
        fn(*args, **kwargs)
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "kernels": {k: list(v) for k, v in mode.kernels.items()}}
