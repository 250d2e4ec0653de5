"""Plain-layout depthwise 3-D conv with SAME ``⌊k/2⌋`` zero padding, and
its backward: the port of ``coarse_fine_networks_tpu/ops/pallas/dw_conv.py``.

:func:`depthwise_conv3d` is the counterpart of the JAX dispatcher of the
same name, differentiable, on channels-last ``(B, T, H, W, C)`` tensors with
taps ``(KT, KH, KW, C)`` in x's dtype.  It routes by the strides and the tap
shape only:

* stride ``(1, 1, 1)``, odd ``KT ≤ 7``, odd ``KH == KW ≤ 3`` (the stem's
  ``conv1_t`` is 5×1×1): :class:`DwStencil3d`, the port of ``_dw_pallas``'s
  custom VJP: the forward is K11, dx is K11 on g with the flipped taps, and
  the taps' gradient is :func:`dw_stencil_wgrad`;
* stride ``(1, 2, 2)`` with 3×3×3 taps: the forward is K7, the backward is
  K8 and the plain mode of K10 (:mod:`.dw_conv`), as :class:`..dw_conv.DwConv3d`
  runs them; K7 is the function of K4 plain (``dw_conv_s2``), and its wrapper
  launches K4 plain's kernel;
* anything else raises.  (The JAX package's ``impl="pallas"`` ignores the
  strides and returns a stride-1 result; the port does not copy that.)

Kernels (CUDA C++ for ``sm_90a``, :mod:`._build`), each with a thread per
vector of channels at a pixel and a ``cp.async`` ring of x frames in the
thread's own shared-memory slots:

* ``dw_stencil_s1`` (K11, ``_dw_pallas_raw`` → ``_stencil_kernel``;
  ``csrc/dw_stencil.cu``): :func:`dw_stencil3d` at stride 1, a register
  ring of the output frames a frame of x feeds, one block per (sample,
  frame segment, pixel range) item (:func:`plan_stencil_fwd` mirrors its
  split);
* ``dw_stencil_s2`` (K7, ``dw_fold.py:_dw_fold4_s2_raw``): :func:`dw_stencil3d`
  at stride (1, 2, 2), K4 plain's kernel (``dw_conv_s2`` in
  ``csrc/dw_plain_s2.cu``, split by :func:`..dw_conv.plan_s2_fwd`), counted
  here under K7's name; its plain version on the CPU is K4 plain's,
  :func:`..dw_conv.dw_conv3d_plain`;
* ``dw_stencil_wgrad`` (the per-tap reduce of ``_dw_bwd``, which the JAX
  package leaves to XLA; ``csrc/dw_stencil.cu``): :func:`dw_stencil_wgrad`,
  a persistent grid of block rows (:func:`plan_stencil_wgrad` mirrors its
  split), partial sums added with one ``torch.sum``.

Each wrapper runs its plain version on a CPU tensor and launches its kernel
on a CUDA tensor, or raises.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils.hw import Work, kernel_work
from ._build import CudaLibrary, I, P
from .dw_conv import (LIBRARY_S2, dw_conv3d_plain, dw_conv_dx_s2,
                      dw_conv_wgrad, plan_s2_fwd)
from .dw_mm_act import _launch

LIBRARY = CudaLibrary("dw_stencil.cu", {
    "dw_stencil_partial_rows": [I] * 7,
    "dw_stencil_s1": [P] * 3 + [I] * 8 + [P],
    "dw_stencil_s1_occupancy": [I] * 4,
    "dw_stencil_wgrad": [P] * 3 + [I] * 8 + [P],
})
# K7's kernel: K4 plain's, in csrc/dw_plain_s2.cu
K7_LIBRARY, K7_ENTRY = LIBRARY_S2, "dw_conv_s2"

# The kernels' tap shapes at stride 1: odd KT up to 7, KH == KW in {1, 3};
# the largest tap count is 7·3·3 = 63.
MAX_KT, MAX_KS = 7, 3

# Kernel launches since the last reset, by kernel name.  Incremented only
# where a kernel is launched (never by a plain version).
LAUNCHES = {"dw_stencil_s1": 0, "dw_stencil_s2": 0, "dw_stencil_wgrad": 0}

S1, S2 = (1, 1, 1), (1, 2, 2)

# The kernels' work split (``wg_plan`` and ``fwd_plan`` in
# ``csrc/dw_stencil.cu``): threads per block at most, the taps' gradient's
# persistent grid (two blocks per SM of the H100's 132), frames per segment
# at least where T is split, and the forward's blocks at least where T is
# split (eight per SM); frames in the forward's ring of x
WG_THREADS, WG_BLOCKS, WG_TT_MIN = 192, 264, 8
FWD_BLOCKS, FWD_DEPTH = 1056, 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stencil_supported(ksize, strides) -> bool:
    """Whether the kernels take taps of shape ``ksize (KT, KH, KW)`` at
    ``strides``: see the module docstring."""
    kt, kh, kw = ksize
    if tuple(strides) == S1:
        return (kt % 2 == 1 and kh % 2 == 1 and kh == kw and kt <= MAX_KT
                and kh <= MAX_KS)
    return tuple(strides) == S2 and tuple(ksize) == (3, 3, 3)


def _out_shape(x, strides):
    b, t, h, w, c = x.shape
    _, sh, sw = strides
    return (b, t, (h - 1) // sh + 1, (w - 1) // sw + 1, c)


def _check(x, w=None, strides=S1, g=None, ksize=None):
    """Raise on what the kernels do not take: x ``(B, T, H, W, C)`` f32 or
    bf16; taps ``w (KT, KH, KW, C)`` of a supported shape at ``strides`` and
    ``g`` (y's shape at stride 1) in x's dtype, all contiguous on x's device,
    a CPU or CUDA device."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be (B, T, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    tensors = [("x", x)]
    if w is not None:
        if w.dim() != 4 or w.shape[-1] != c:
            raise ValueError(f"w must be (KT, KH, KW, {c}), got "
                             f"{tuple(w.shape)}")
        ksize = tuple(w.shape[:3])
        tensors.append(("w", w))
    if not stencil_supported(ksize, strides):
        raise ValueError(f"no kernel for taps {ksize} at strides "
                         f"{tuple(strides)}: stride (1, 1, 1) takes odd "
                         f"KT <= {MAX_KT} and odd KH == KW <= {MAX_KS}, "
                         f"stride (1, 2, 2) takes (3, 3, 3)")
    if g is not None:
        if tuple(g.shape) != tuple(x.shape):
            raise ValueError(f"g must be {tuple(x.shape)}, got "
                             f"{tuple(g.shape)}")
        tensors.append(("g", g))
    for name, v in tensors:
        if v.dtype != x.dtype:
            raise TypeError(f"{name} must have x's dtype {x.dtype}, got "
                            f"{v.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")


def _pad(x, ksize):
    """x in f32, zero-padded by ``⌊k/2⌋`` on T, H and W."""
    pt, ph, pw = (k // 2 for k in ksize)
    return F.pad(x.float(), (0, 0, pw, pw, ph, ph, pt, pt))


# ---- the kernels' work split (csrc/dw_stencil.cu) ---------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class StencilPlan(NamedTuple):
    """How ``dw_stencil_s1`` and ``dw_stencil_wgrad`` split x ``(B, T, H,
    W, C)``: a thread owns ``v`` consecutive channels at one pixel; a block
    ``nvb`` such vectors (a channel group; ``n_cg`` groups) at ``pp``
    pixels, thread ``tid`` at pixel ``tid // nvb``; items are (sample,
    segment of ``tt`` frames, range of ``pp`` pixels), ranges fastest.  The
    taps' gradient's block row ``r`` walks items ``[r·ipb, (r+1)·ipb)`` of
    every group and writes row ``r`` of the ``(rows, taps, C)`` partials;
    the forward's block ``(item, group)`` takes one item (``ipb`` 1,
    ``rows`` the items)."""
    v: int
    nvb: int
    n_cg: int
    pp: int
    tt: int
    n_tseg: int
    npr: int
    items: int
    ipb: int
    rows: int

    @property
    def threads(self) -> int:
        return self.pp * self.nvb


@lru_cache(maxsize=None)
def plan_stencil_wgrad(b: int, t: int, h: int, w: int, c: int, kt: int,
                       ks: int) -> StencilPlan:
    """The source's ``wg_plan`` for x ``(B, T, H, W, C)`` and taps ``kt ×
    ks × ks``: vectors of 8 channels for ``ks`` 1 up to ``kt`` 5 (fewer
    beyond, whose sums would not fit in registers: ``wg_vec``), whole warps
    of whole pixels where 32 pixels fit in ``WG_THREADS``, frames halved
    (down to ``WG_TT_MIN``) until there are ``WG_BLOCKS`` items, about
    ``WG_BLOCKS`` block rows."""
    v = (8 if kt <= 5 else 4) if ks == 1 else 2 if kt <= 3 else 1
    nv = _cdiv(c, v)
    nvb = min(nv, WG_THREADS)
    n_cg = _cdiv(nv, nvb)
    pp = (WG_THREADS // (32 * nvb) * 32 if 32 * nvb <= WG_THREADS
          else WG_THREADS // nvb)
    npr = _cdiv(h * w, pp)
    tt = t
    while tt > WG_TT_MIN and b * _cdiv(t, tt) * npr < WG_BLOCKS:
        tt = max(WG_TT_MIN, _cdiv(tt, 2))
    n_tseg = _cdiv(t, tt)
    items = b * n_tseg * npr
    ipb = _cdiv(items, min(items, max(1, WG_BLOCKS // n_cg)))
    return StencilPlan(v, nvb, n_cg, pp, tt, n_tseg, npr, items, ipb,
                       _cdiv(items, ipb))


@lru_cache(maxsize=None)
def plan_stencil_fwd(b: int, t: int, h: int, w: int, c: int, kt: int,
                     ks: int) -> StencilPlan:
    """The source's ``fwd_plan`` (``dw_stencil_s1``'s split) for x ``(B, T,
    H, W, C)`` and taps ``kt × ks × ks``: :func:`plan_stencil_wgrad`'s
    vectors, pixels and items, the frames halved on (down to
    ``WG_TT_MIN``) until there are ``FWD_BLOCKS`` items; a grid of ``items
    × n_cg`` blocks, one item each."""
    p = plan_stencil_wgrad(b, t, h, w, c, kt, ks)
    tt, n_tseg, items = p.tt, p.n_tseg, p.items
    while tt > WG_TT_MIN and items < FWD_BLOCKS:
        tt = max(WG_TT_MIN, _cdiv(tt, 2))
        n_tseg = _cdiv(t, tt)
        items = b * n_tseg * p.npr
    return p._replace(tt=tt, n_tseg=n_tseg, items=items, ipb=1, rows=items)


# ---- forward: K11 (stride 1) and K7 (stride (1, 2, 2)) --------------------

def dw_stencil3d_plain(x: torch.Tensor, w: torch.Tensor,
                       strides=S1) -> torch.Tensor:
    """The shift-and-add of the JAX package's ``_shift_add_fwd_impl``: the
    depthwise sum over the taps of x zero-padded by ``⌊k/2⌋``, in f32 at
    ``strides``, written in x's dtype.

    The taps are added in the order (dt, dh, dw), each as one fused
    multiply-add onto the f32 sum (the product and the add rounded once: the
    exact f64 sum of the f32 sum and the exact product, rounded to f32), as
    the kernels' ``fmaf`` chain and PyTorch's CPU convolution add them."""
    ksize = tuple(w.shape[:3])
    xp = _pad(x, ksize).double()
    shape = _out_shape(x, strides)
    _, to, ho, wo, _ = shape
    st, sh, sw = strides
    wf = w.double()
    y = torch.zeros(shape, dtype=torch.float32, device=x.device)
    for dt in range(ksize[0]):
        for dh in range(ksize[1]):
            for dw in range(ksize[2]):
                term = xp[:, dt:dt + st * (to - 1) + 1:st,
                          dh:dh + sh * (ho - 1) + 1:sh,
                          dw:dw + sw * (wo - 1) + 1:sw] * wf[dt, dh, dw]
                y = (y.double() + term).float()
    return y.to(x.dtype)


# ---- the work of each kernel's function (its roofline bound; the count of
# ``utils.hw.program_costs``): x, g or y and the taps moved once, the f32
# taps' gradient written once; a multiply-add a tap and output (or g)
# element

def fwd_work(y, x, w, strides=S1) -> Work:
    """:func:`dw_stencil3d`'s work, ``y`` its output."""
    taps = w.shape[0] * w.shape[1] * w.shape[2]
    return Work((x.numel() + y.numel() + w.numel()) * x.element_size(),
                2 * taps * y.numel())


def wgrad_work(dk, x, g, ksize) -> Work:
    """:func:`dw_stencil_wgrad`'s work, ``dk`` its output."""
    taps = ksize[0] * ksize[1] * ksize[2]
    return Work((x.numel() + g.numel()) * x.element_size()
                + taps * x.shape[-1] * 4, 2 * taps * g.numel())


@kernel_work(fwd_work)
def dw_stencil3d(x: torch.Tensor, w: torch.Tensor,
                 strides=S1) -> torch.Tensor:
    """Depthwise conv of ``x (B, T, H, W, C)`` with taps ``w (KT, KH, KW,
    C)`` at ``strides`` (see :func:`dw_stencil3d_plain`; the shapes of
    :func:`stencil_supported`).  Returns ``(B, T, ⌈H/s⌉, ⌈W/s⌉, C)`` in x's
    dtype.  A CPU tensor takes the plain version (at stride (1, 2, 2) K4
    plain's, :func:`..dw_conv.dw_conv3d_plain`); a CUDA tensor launches
    ``dw_stencil_s1`` or, counted as ``dw_stencil_s2``, K4 plain's
    ``dw_conv_s2``, or raises."""
    strides = tuple(strides)
    _check(x, w, strides)
    if x.device.type == "cpu":
        if strides == S2:
            return dw_conv3d_plain(x, w, 2)
        return dw_stencil3d_plain(x, w, strides)
    y = torch.empty(_out_shape(x, strides), dtype=x.dtype, device=x.device)
    if not y.numel():
        return y
    dims = x.shape
    if strides == S1:
        _launch(LAUNCHES, LIBRARY, "dw_stencil_s1", x, x.data_ptr(),
                w.data_ptr(), y.data_ptr(), *dims, w.shape[0], w.shape[1])
    else:
        p = plan_s2_fwd(*dims)
        _launch(LAUNCHES, K7_LIBRARY, K7_ENTRY, x, x.data_ptr(),
                w.data_ptr(), y.data_ptr(), *dims, p.r, p.wb, p.pg, p.tt,
                key="dw_stencil_s2")
    return y


# ---- the taps' gradient at stride 1 -----------------------------------------

def dw_stencil_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                           ksize) -> torch.Tensor:
    """The per-tap reduce of ``_dw_bwd``: ``dk[tap, c] = Σ_pos
    x_pad[pos + tap, c]·g[pos, c]`` in f32, ``(KT·KH·KW, C)``."""
    xp = _pad(x, ksize)
    _, t, h, w, _ = x.shape
    gf = g.float()
    taps = []
    for dt in range(ksize[0]):
        for dh in range(ksize[1]):
            for dw in range(ksize[2]):
                taps.append(torch.sum(xp[:, dt:dt + t, dh:dh + h, dw:dw + w]
                                      * gf, dim=(0, 1, 2, 3)))
    return torch.stack(taps)


@kernel_work(wgrad_work)
def dw_stencil_wgrad(x: torch.Tensor, g: torch.Tensor,
                     ksize) -> torch.Tensor:
    """The taps' gradient of :func:`dw_stencil3d` at stride 1 for taps of
    shape ``ksize`` (see :func:`dw_stencil_wgrad_plain`), ``(KT·KH·KW, C)``
    f32.  A CPU tensor takes the plain version; a CUDA tensor launches
    ``dw_stencil_wgrad`` (a partial row per block row of its persistent
    grid, added with one ``torch.sum``), or raises."""
    ksize = tuple(ksize)
    _check(x, None, S1, g, ksize)
    if x.device.type == "cpu":
        return dw_stencil_wgrad_plain(x, g, ksize)
    taps = ksize[0] * ksize[1] * ksize[2]
    if not g.numel():
        return torch.zeros((taps, x.shape[-1]), device=x.device)
    b, t, h, w, c = x.shape
    rows = LIBRARY.build().dw_stencil_partial_rows(b, t, h, w, c, ksize[0],
                                                   ksize[1])
    part = torch.empty((rows, taps, c), dtype=torch.float32, device=x.device)
    _launch(LAUNCHES, LIBRARY, "dw_stencil_wgrad", x, x.data_ptr(),
            g.data_ptr(), part.data_ptr(), b, t, h, w, c, ksize[0], ksize[1])
    return torch.sum(part, dim=0)


# ---- autograd ---------------------------------------------------------------

class DwStencil3d(torch.autograd.Function):
    """:func:`dw_stencil3d` with the kernels' backward.  At stride 1 (the
    JAX package's ``_dw_bwd``): dx is :func:`dw_stencil3d` of g with the
    flipped taps, the taps' gradient :func:`dw_stencil_wgrad`.  At stride
    (1, 2, 2): dx is :func:`..dw_conv.dw_conv_dx_s2` (K8), the taps'
    gradient :func:`..dw_conv.dw_conv_wgrad` (K10 plain).  The taps'
    gradient is returned in the taps' dtype."""

    @staticmethod
    def forward(ctx, x, w, strides):
        ctx.strides = tuple(strides)
        ctx.save_for_backward(x, w)
        return dw_stencil3d(x, w, strides)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        if ctx.strides == S1:
            dx = dw_stencil3d(g, torch.flip(w, (0, 1, 2)).contiguous())
            dk = dw_stencil_wgrad(x, g, w.shape[:3])
        else:
            dx = dw_conv_dx_s2(g, w, x.shape[2:4])
            dk = dw_conv_wgrad(x, g, 2)
        return dx, dk.reshape(w.shape).to(w.dtype), None


def depthwise_conv3d(x: torch.Tensor, w: torch.Tensor,
                     strides=S1) -> torch.Tensor:
    """Depthwise 3-D conv, channels-last, SAME ``⌊k/2⌋`` padding, inside
    autograd: ``x (B, T, H, W, C)``, taps ``w (KT, KH, KW, C)`` in x's
    dtype.  Stride ``(1, 1, 1)`` with odd ``KT ≤ 7`` and odd ``KH == KW ≤
    3``, or ``(1, 2, 2)`` with 3×3×3 taps, runs :class:`DwStencil3d`; any
    other stride or tap shape raises ``ValueError``."""
    strides = tuple(strides)
    if not stencil_supported(tuple(w.shape[:3]), strides):
        raise ValueError(f"depthwise_conv3d: no route for taps "
                         f"{tuple(w.shape[:3])} at strides {strides}")
    return DwStencil3d.apply(x, w, strides)
