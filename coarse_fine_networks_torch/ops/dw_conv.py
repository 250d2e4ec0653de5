"""Plain depthwise 3³ conv of the split-batch-norm training route, with its
backward: ``y = dwconv3³_(1,s,s)(a)``.

In training with split batch norm (``bn1.num_splits > 1``) every
:class:`..models.x3d.Bottleneck` normalises conv1's output per split and
applies the ReLU in PyTorch, then enters the depthwise conv2 through
:class:`DwConv3d`: one forward kernel, and in the backward one dx kernel and
one weight-gradient kernel.  It is the counterpart of the JAX package's
``dw_fold4`` and ``dw_fold4_stride2``
(``coarse_fine_networks_tpu/ops/pallas/dw_fold.py``), whose forward is the
plain mode of the Pallas kernels K1/K4 and whose backward is K1 again on the
flipped taps (stride-1 dx), K8 (stride-2 dx) and the plain mode of K6/K10.

Kernels (CUDA C++ for ``sm_90a``, :mod:`._build`):

* ``dw_conv_s1``: :func:`dw_conv3d` at stride 1, in ``csrc/dw_plain_s1.cu``
  (full-width row strips staged by ``cp.async``, a channel pair per thread,
  a register ring along T); on ``g`` with the flipped taps it is also the
  stride-1 dx;
* ``dw_conv_wgrad_s1``: :func:`dw_conv_wgrad` at stride 1, in the same
  source (the same staging and threads, a persistent grid); both take the
  work split of :func:`plan_s1`;
* ``dw_conv_s2``: :func:`dw_conv3d` at stride 2, in ``csrc/dw_mm_act.cu``
  (the plain mode of the bottleneck-entry kernel);
* ``dw_conv_dx_s2``: :func:`dw_conv_dx_s2`, in ``csrc/dw_act_bwd.cu`` (the
  act-mode stride-2 dx without the mask, the scale and the sums);
* ``dw_conv_wgrad_s2``: :func:`dw_conv_wgrad` at stride 2, in
  ``csrc/dw_act_bwd.cu``.

Each wrapper runs its ``*_plain`` version on a CPU tensor and launches its
kernel on a CUDA tensor, or raises.  All tensors are channels-last
``(B, T, H, W, C)``; stride 2 means ``(1, 2, 2)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._build import CudaLibrary, I, P
from .dw_act import _check
from .dw_mm_act import BWD_LIBRARY, _launch, _out_hw, _partials
from .dw_mm_act import LIBRARIES as ENTRY_LIBRARIES
from .dw_mm_act import LIBRARY as FWD_LIBRARY
from .dw_mm_act import stencil_f32, wgrad_f32

# The stride-1 kernels; the stride-2 ones are in the bottleneck entry's
# sources (FWD_LIBRARY, BWD_LIBRARY).
LIBRARY = CudaLibrary("dw_plain_s1.cu", {
    "dw_conv_s1": [P] * 3 + [I] * 10 + [P],
    "dw_conv_wgrad_s1": [P] * 3 + [I] * 12 + [P],
    "dw_plain_s1_occupancy": [I] * 5,
})
# every source this module's kernels are in
LIBRARIES = ENTRY_LIBRARIES + (LIBRARY,)

# Kernel launches since the last reset, by kernel name.  Incremented only
# where a kernel is launched (never by a plain version).
LAUNCHES = {"dw_conv_s1": 0, "dw_conv_s2": 0, "dw_conv_dx_s2": 0,
            "dw_conv_wgrad_s1": 0, "dw_conv_wgrad_s2": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- the stride-1 kernels' work split ------------------------------------------

NT_MAX = 256  # threads per block at most (csrc/dw_plain_s1.cu)
RMIN, RMAX = 2, 4  # output rows per strip (a template argument there)
TT_MIN = 8    # frames per segment at least, where the forward splits T
NSTAGE = 3    # frames in the kernels' shared-memory ring
SMS = 132     # the H100's SMs
# the forward aims at two waves at two blocks per SM; the weight gradient's
# persistent grid at two blocks per SM
FWD_BLOCKS, WG_BLOCKS = 4 * SMS, 2 * SMS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PlanS1(NamedTuple):
    """How ``dw_conv_s1`` and ``dw_conv_wgrad_s1`` split ``(B, T, H, W,
    C)``: a block owns ``r`` output rows × ``wb`` columns × ``pg`` channel
    pairs of one sample over ``tt`` frames; the forward has one block per
    tile, the weight gradient ``rows`` blocks per channel group, each
    walking ``ipb`` consecutive items (its row of the partial buffer)."""
    b: int
    t: int
    h: int
    w: int
    c: int
    r: int
    wb: int
    pg: int
    tt: int
    ipb: int
    rows: int

    @property
    def n_strip(self) -> int:
        return _cdiv(self.h, self.r)

    @property
    def n_wt(self) -> int:
        return _cdiv(self.w, self.wb)

    @property
    def n_pg(self) -> int:
        return _cdiv(_cdiv(self.c, 2), self.pg)

    @property
    def n_tseg(self) -> int:
        return _cdiv(self.t, self.tt)

    @property
    def items(self) -> int:
        """Work items of one channel group."""
        return self.b * self.n_tseg * self.n_strip * self.n_wt

    @property
    def threads(self) -> int:
        return _cdiv(self.wb * self.pg, 32) * 32

    def tile(self, item: int, pg: int):
        """``(b, (t0, t1), (h0, h1), (w0, w1), (c0, c1))`` of an item and a
        channel group, clipped to the tensor: ``Plan::tile`` of the
        source."""
        w0 = item % self.n_wt * self.wb
        item //= self.n_wt
        h0 = item % self.n_strip * self.r
        item //= self.n_strip
        t0 = item % self.n_tseg * self.tt
        b = item // self.n_tseg
        c0 = 2 * pg * self.pg
        return (b, (t0, min(t0 + self.tt, self.t)),
                (h0, min(h0 + self.r, self.h)),
                (w0, min(w0 + self.wb, self.w)),
                (c0, min(c0 + 2 * self.pg, self.c)))

    def smem(self, esz: int, wgrad: bool) -> int:
        """Dynamic shared memory per block, in bytes, as the source's
        launchers size it."""
        def stage(rows):
            return _cdiv(rows * (self.wb + 2) * 2 * self.pg * esz, 16) * 16
        if not wgrad:
            return NSTAGE * stage(self.r + 2)
        ring = NSTAGE * (stage(self.r + 2) + stage(self.r))
        return max(ring, 4 * 27 * self.wb * 2 * self.pg)


def plan_s1(b: int, t: int, h: int, w: int, c: int) -> PlanS1:
    """The work split of the stride-1 kernels for x ``(B, T, H, W, C)``.

    Columns: all W in one block where W ≤ 256 (so at least two where W
    is: the kernels stage the halo columns with the threads of columns 0
    and 1).  Channel pairs: as many as fill 256 threads with the block's
    columns, in equal groups.  Rows: strips of 2 to 4, of equal height
    (rows past H read the zero padding).  Frames: the whole clip, halved
    (down to 8) until the forward has two waves of blocks.  The weight
    gradient walks the same items, ``ipb`` per block, on about two blocks
    per SM."""
    p2 = _cdiv(c, 2)
    wb = _cdiv(w, _cdiv(w, NT_MAX))
    pg = _cdiv(p2, _cdiv(p2, max(1, NT_MAX // wb)))
    r = max(RMIN, _cdiv(h, _cdiv(h, RMAX)))
    plan = PlanS1(b, t, h, w, c, r, wb, pg, t, 1, 1)
    tt = t
    while tt > TT_MIN and (plan._replace(tt=tt).items * plan.n_pg
                           < FWD_BLOCKS):
        tt = max(TT_MIN, _cdiv(tt, 2))
    plan = plan._replace(tt=tt)
    ipb = _cdiv(plan.items, max(1, min(plan.items, WG_BLOCKS // plan.n_pg)))
    return plan._replace(ipb=ipb, rows=_cdiv(plan.items, ipb))


# ---- forward: the plain mode of K1 (stride 1) and K4 (stride 2) -------------

def dw_conv3d_plain(x: torch.Tensor, w_dw: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """The 27-tap depthwise sum of x, zero-padded by one on T, H and W, in
    f32 at stride ``(1, s, s)``, written in x's dtype."""
    return stencil_f32(x, w_dw, stride).to(x.dtype)


def dw_conv3d(x: torch.Tensor, w_dw: torch.Tensor,
              stride: int) -> torch.Tensor:
    """Depthwise 3³ conv at stride ``(1, s, s)`` with SAME zero padding.

    Args:
      x: ``(B, T, H, W, C)`` float32 or bfloat16, contiguous.
      w_dw: ``(3, 3, 3, C)`` depthwise taps in x's dtype.
      stride: 1, or 2 for stride (1, 2, 2).

    Returns ``(B, T, ⌈H/s⌉, ⌈W/s⌉, C)`` in x's dtype.  A CPU tensor takes
    :func:`dw_conv3d_plain`; a CUDA tensor launches ``dw_conv_s1`` or
    ``dw_conv_s2``, or raises."""
    _check(x, w_dw, None, None, stride)
    if x.device.type == "cpu":
        return dw_conv3d_plain(x, w_dw, stride)
    b, t, h, w, c = x.shape
    y = torch.empty((b, t) + _out_hw(h, w, stride) + (c,), dtype=x.dtype,
                    device=x.device)
    if not y.numel():
        return y
    if stride == 1:
        p = plan_s1(b, t, h, w, c)
        _launch(LAUNCHES, LIBRARY, "dw_conv_s1", x, x.data_ptr(),
                w_dw.data_ptr(), y.data_ptr(), b, t, h, w, c, p.r, p.wb,
                p.pg, p.tt)
    else:
        _launch(LAUNCHES, FWD_LIBRARY, "dw_conv_s2", x, x.data_ptr(),
                w_dw.data_ptr(), y.data_ptr(), b, t, h, w, c)
    return y


# ---- dx at stride 2: K8 ----------------------------------------------------------

def dw_conv_dx_s2_plain(g: torch.Tensor, w_dw: torch.Tensor,
                        hw: tuple[int, int]) -> torch.Tensor:
    """``dx[t, r, q] = Σ w[dt, dy, dx]·g[t−dt+1, (r−dy+1)/2, (q−dx+1)/2]``
    over the terms whose divisions are integral: the correlation of g placed
    at the even positions of a zero ``(B, T, H, W, C)`` tensor with the
    flipped taps, in f32, written in g's dtype."""
    b, t, _, _, c = g.shape
    up = torch.zeros((b, t) + tuple(hw) + (c,), dtype=torch.float32,
                     device=g.device)
    up[:, :, ::2, ::2] = g.float()
    return stencil_f32(up, torch.flip(w_dw, (0, 1, 2)), 1).to(g.dtype)


def dw_conv_dx_s2(g: torch.Tensor, w_dw: torch.Tensor,
                  hw: tuple[int, int]) -> torch.Tensor:
    """dx of :func:`dw_conv3d` at stride 2: ``g (B, T, ⌈H/2⌉, ⌈W/2⌉, C)``
    → ``(B, T, H, W, C)`` with ``hw = (H, W)`` (see
    :func:`dw_conv_dx_s2_plain`).  A CPU tensor takes the plain version; a
    CUDA tensor launches ``dw_conv_dx_s2``, or raises."""
    _check(g, w_dw, None, None, 1)
    b, t, ho, wo, c = g.shape
    if (ho, wo) != _out_hw(hw[0], hw[1], 2):
        raise ValueError(f"g's H, W {(ho, wo)} are not those of stride 2 "
                         f"from {tuple(hw)}")
    shape = (b, t) + tuple(hw) + (c,)
    if g.device.type == "cpu":
        return dw_conv_dx_s2_plain(g, w_dw, hw)
    dx = torch.empty(shape, dtype=g.dtype, device=g.device)
    if dx.numel():
        _launch(LAUNCHES, BWD_LIBRARY, "dw_conv_dx_s2", g, g.data_ptr(),
                w_dw.data_ptr(), dx.data_ptr(), *shape)
    return dx


# ---- wgrad: the plain mode of K6 (stride 1) and K10 (stride 2) -------------------

def dw_conv_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """``dk[tap, c] = Σ_pos x_pad[s·pos + tap]·g[pos]`` in f32:
    ``(27, C)``."""
    return wgrad_f32(x, g, stride)


def dw_conv_wgrad(x: torch.Tensor, g: torch.Tensor,
                  stride: int) -> torch.Tensor:
    """Weight gradient of :func:`dw_conv3d` (see :func:`dw_conv_wgrad_plain`),
    ``(27, C)`` f32.  A CPU tensor takes the plain version; a CUDA tensor
    launches ``dw_conv_wgrad_s1`` or ``dw_conv_wgrad_s2`` (per-block partial
    sums, added with one ``torch.sum``), or raises."""
    _check(x, None, None, None, stride, g)
    if x.device.type == "cpu":
        return dw_conv_wgrad_plain(x, g, stride)
    if not g.numel():
        return torch.zeros((27, x.shape[-1]), device=x.device)
    if stride == 1:
        p = plan_s1(*x.shape)
        part = torch.empty((p.rows, 27, x.shape[-1]), dtype=torch.float32,
                           device=x.device)
        _launch(LAUNCHES, LIBRARY, "dw_conv_wgrad_s1", x, x.data_ptr(),
                g.data_ptr(), part.data_ptr(), *x.shape, p.r, p.wb, p.pg,
                p.tt, p.ipb, p.rows)
    else:
        part = _partials("dw_conv_wgrad_s2", x, 27)
        _launch(LAUNCHES, BWD_LIBRARY, "dw_conv_wgrad_s2", x, x.data_ptr(),
                g.data_ptr(), part.data_ptr(), *x.shape)
    return torch.sum(part, dim=0)


# ---- autograd ---------------------------------------------------------------------

class DwConv3d(torch.autograd.Function):
    """:func:`dw_conv3d` with the kernels' backward (the JAX package's
    ``_dw_fold4_bwd`` and ``_dw_s2_bwd``): at stride 1 dx is
    :func:`dw_conv3d` of g with the flipped taps, at stride 2
    :func:`dw_conv_dx_s2`; the taps' gradient is :func:`dw_conv_wgrad`,
    returned in the taps' dtype."""

    @staticmethod
    def forward(ctx, x, w_dw, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w_dw)
        return dw_conv3d(x, w_dw, stride)

    @staticmethod
    def backward(ctx, g):
        x, w_dw = ctx.saved_tensors
        g = g.contiguous()
        if ctx.stride == 1:
            dx = dw_conv3d(g, torch.flip(w_dw, (0, 1, 2)).contiguous(), 1)
        else:
            dx = dw_conv_dx_s2(g, w_dw, x.shape[2:4])
        dk = dw_conv_wgrad(x, g, ctx.stride)
        return dx, dk.reshape(3, 3, 3, -1).to(w_dw.dtype), None


# ``dw_conv3d_train(x, w_dw, stride)``: :func:`dw_conv3d` inside autograd
dw_conv3d_train = DwConv3d.apply
