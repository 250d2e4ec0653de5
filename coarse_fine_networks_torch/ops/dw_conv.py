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

Kernels (CUDA C++ for ``sm_90a``, :mod:`._build`), all bound by bytes
(27 MACs per output element, far below the ~295 operations per byte where
the tensor cores would matter), so each reads its input once with a small
halo and writes its output once:

* ``dw_conv_s1``: :func:`dw_conv3d` at stride 1, in ``csrc/dw_plain_s1.cu``
  (full-width row strips staged by ``cp.async``, a channel pair per thread,
  a register ring along T); on ``g`` with the flipped taps it is also the
  stride-1 dx;
* ``dw_conv_wgrad_s1``: :func:`dw_conv_wgrad` at stride 1, in the same
  source (the same staging and threads, a persistent grid); both take the
  work split of :func:`plan_s1`;
* ``dw_conv_s2`` (K4 plain; replaces the plain mode of
  ``dw_fold.py:_fwd_s2_direct_pcall`` :1078): :func:`dw_conv3d` at stride
  2, in ``csrc/dw_plain_s2.cu``: the 2R+1 input rows of an output strip
  staged by ``cp.async`` with each row stored de-interleaved (even columns,
  then odd), so a warp's stride-2 reads are consecutive words, and a
  register ring of output frames along T; it adds each output's taps in
  K11's order (dt, dy, dx, one fused multiply-add each); split by
  :func:`plan_s2_fwd`.  It is also K7: :mod:`.dw_stencil` launches it for
  ``dw_stencil_s2``;
* ``dw_conv_dx_s2`` (K8; replaces ``dw_fold.py:_dx_s2_pcall`` :1208):
  :func:`dw_conv_dx_s2`, in the same source: a gather from the staged
  half-resolution g, each thread the 2×2 quads of dx over its g column (27
  MACs a quad, no branch), one dx frame summed from a 5-frame g ring in
  shared memory and written once; it adds the terms in the order K11 adds
  them on the zero-upsampled g with the flipped taps and equals that bit
  for bit; split by :func:`plan_s2_dx` over g, channel pairs first, so
  that its stores, 4/5 of its bytes, fill whole sectors;
* ``dw_conv_wgrad_s2`` (K10 plain): :func:`dw_conv_wgrad` at stride 2, in
  the same source (the stride-1 weight gradient's staging and threads over
  the output's row strips, the forward's de-interleaved rows), with the
  work split of :func:`plan_s2`;
* ``dw_conv_t2``, ``dw_conv_dx_t2``, ``dw_conv_wgrad_t2``: the same three
  at stride (2, 2, 2), :class:`..models.fine.FineNet`'s ``t_downsample``
  (replacing no TPU kernel: the JAX package runs that conv in XLA,
  ``_lax_conv``, ``ops/pallas/dw_conv.py:287``), in the same source, each
  with a body of its own.  The forward takes one step an output frame:
  input frames 2o and 2o+1 arrive together, whole pixels by a TMA bulk
  copy a row where the group is the pixel (:func:`t2_whole`), and two
  output frames sit in registers.  The dx sums each g frame's two dx
  frames (the even one through tap dt = 1 only) from a 4-frame g ring
  into tiles in shared memory, written out as contiguous runs by bulk
  copies (else each thread's pairs straight to dx).  The weight gradient
  has a walk of its own on K10 plain's threads
  and rows: one step a g frame, all 27 taps against x frames 2o-1, 2o and
  2o+1 from a ring of five x frames and two g frames, a block's items (one
  clip each) chained into one stream of steps; work splits
  :func:`plan_t2_fwd`, :func:`plan_t2_dx` and :func:`plan_t2` over the
  output's (g's) frames.

The two plain sources also hold the act modes of their kernels, entries
of :mod:`.dw_act` bound here: ``dw_act_s1`` (K1 act) and
``dw_act_wgrad_s1`` (K6 act), K1 and K6 plain's bodies on x activated in
place a frame ahead of the stencil, with :func:`plan_s1`; ``dw_act_s2``
(K4 act), K4 plain's body likewise, with :func:`plan_act_s2_fwd`;
``dw_act_wgrad_s2`` (K10 act), K10 plain's body likewise, with
:func:`plan_s2`; and ``dw_act_dx_s2`` (K5, K8's body with the relu mask,
``dx = dam·sc`` and the ``(dsc, dbi)`` sums, with :func:`plan_act_dx_s2`).
``dw_plain_s1.cu`` also holds ``dw_mm_wgrad_s1`` (K6 mm of
:mod:`.dw_mm_act`: K1 ``mm``'s product on K6 plain's walk, with
:func:`plan_mm_wgrad_s1`), and ``dw_plain_s2.cu`` ``dw_mm_act_s2`` (K4
``mm`` of :mod:`.dw_mm_act`: K1 ``mm``'s product on K4 plain's strips and
stencil, with :func:`plan_mm_s2_fwd`), ``dw_mm_dx_mask_s2`` (K9 of
:mod:`.dw_mm_bn_train`: K8's body with K2's mask phase, with
:func:`plan_mm_dx_s2`) and ``dw_mm_wgrad_s2`` (K10 mm of
:mod:`.dw_mm_act`: K4 ``mm``'s product on K10 plain's walk, with
:func:`plan_mm_wgrad_s2`).  The row-strip weight gradients add ``x·g``
only where g exists in the item (``wgrad_slots``, ``csrc/strip.cuh``), so a
NaN of x reaches the taps it reaches in the plain versions, no others.

The module also computes the row-strip work splits of the other modules'
row-strip kernels: :func:`plan_mm_s1` (K1 ``mm``, :mod:`.dw_mm_act`) and
:func:`plan_act_dx_s1` / :func:`plan_mm_dx_s1` (the stride-1 dx K3 of
:mod:`.dw_act` and K2 of :mod:`.dw_mm_bn_train`, ``csrc/dw_dx_s1.cu``).

Each wrapper runs its ``*_plain`` version on a CPU tensor and launches its
kernel on a CUDA tensor, or raises.  All tensors are channels-last
``(B, T, H, W, C)``; stride 2 means ``(1, 2, 2)``, and ``T2 = (2, 2, 2)``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..utils.hw import Work, kernel_work
from ._build import CudaLibrary, I, P
from .dw_act import _check
from .dw_mm_act import LIBRARIES as ENTRY_LIBRARIES
from .dw_mm_act import _launch, _out_hw, stencil_f32, strides3, wgrad_f32

# The split route's kernels: at stride 1, and at stride (1, 2, 2); each
# source also holds the act modes of its kernels, entries of :mod:`.dw_act`
# (the forward K1 act and the weight gradient K6 act; the forward K4 act,
# the dx K5 and the weight gradient K10 act), the stride-1 one the mm mode
# of its weight gradient, K6 mm of :mod:`.dw_mm_act`, and the stride-2 one
# the mm modes of its forward, dx and weight gradient, K4 mm and K10 mm of
# :mod:`.dw_mm_act` and K9 of :mod:`.dw_mm_bn_train`
LIBRARY = CudaLibrary("dw_plain_s1.cu", {
    "dw_conv_s1": [P] * 3 + [I] * 10 + [P],
    "dw_act_s1": [P] * 5 + [I] * 10 + [P],
    "dw_conv_wgrad_s1": [P] * 3 + [I] * 12 + [P],
    "dw_act_wgrad_s1": [P] * 5 + [I] * 12 + [P],
    "dw_mm_wgrad_s1": [P] * 6 + [I] * 13 + [P],
    "dw_plain_s1_occupancy": [I] * 5,
    "dw_mm_wgrad_s1_occupancy": [I] * 6,
})
LIBRARY_S2 = CudaLibrary("dw_plain_s2.cu", {
    "dw_conv_s2": [P] * 3 + [I] * 10 + [P],
    "dw_act_s2": [P] * 5 + [I] * 10 + [P],
    "dw_conv_dx_s2": [P] * 3 + [I] * 10 + [P],
    "dw_act_dx_s2": [P] * 7 + [I] * 11 + [P],
    "dw_conv_wgrad_s2": [P] * 3 + [I] * 12 + [P],
    "dw_act_wgrad_s2": [P] * 5 + [I] * 12 + [P],
    "dw_plain_s2_occupancy": [I] * 5,
    "dw_mm_act_s2": [P] * 6 + [I] * 11 + [P],
    "dw_mm_act_s2_occupancy": [I] * 6,
    "dw_mm_dx_mask_s2": [P] * 7 + [I] * 11 + [P],
    "dw_mm_dx_mask_s2_occupancy": [I] * 7,
    "dw_mm_wgrad_s2": [P] * 6 + [I] * 13 + [P],
    "dw_mm_wgrad_s2_occupancy": [I] * 6,
    "dw_conv_t2": [P] * 3 + [I] * 11 + [P],
    "dw_conv_dx_t2": [P] * 3 + [I] * 11 + [P],
    "dw_conv_wgrad_t2": [P] * 3 + [I] * 13 + [P],
})
# every source of the bottleneck's depthwise kernels: the entry's (eval
# and train) and the split route's
LIBRARIES = ENTRY_LIBRARIES + (LIBRARY, LIBRARY_S2)

# Kernel launches since the last reset, by kernel name.  Incremented only
# where a kernel is launched (never by a plain version).
LAUNCHES = {"dw_conv_s1": 0, "dw_conv_s2": 0, "dw_conv_dx_s2": 0,
            "dw_conv_wgrad_s1": 0, "dw_conv_wgrad_s2": 0, "dw_conv_t2": 0,
            "dw_conv_dx_t2": 0, "dw_conv_wgrad_t2": 0}
# the stride (2, 2, 2) of FineNet's t_downsample
T2 = (2, 2, 2)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- the row-strip kernels' work splits (csrc/strip.cuh) -----------------------

NT_MAX = 256  # threads per block at most (csrc/strip.cuh)
RMIN, RMAX = 2, 4  # output rows per strip (a template argument there)
TT_MIN = 8    # frames per segment at least, where the forward splits T
NSTAGE = 3    # frames in the kernels' shared-memory ring
NSTAGE_ACT = 4  # ... in the act modes' ring (a frame activated ahead)
SMS = 132     # the H100's SMs
SMEM_MAX = 232448  # a block's shared memory on the H100
# the forward aims at two waves at two blocks per SM; the weight gradient's
# persistent grid at two blocks per SM
FWD_BLOCKS, WG_BLOCKS = 4 * SMS, 2 * SMS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PlanS1(NamedTuple):
    """How a row-strip kernel splits ``(B, T, H, W, C)`` (``h``, ``w``: the
    rows and columns it tiles): a block owns ``r`` rows × ``wb`` columns ×
    ``pg`` channel pairs of one sample over ``tt`` frames; a forward or dx
    has one block per tile, a weight gradient ``rows`` blocks per channel
    group, each walking ``ipb`` consecutive items (its row of the partial
    buffer)."""
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

    def smem(self, esz: int, wgrad: bool, act: bool = False) -> int:
        """Dynamic shared memory per block of a stride-1 kernel (the
        forward or the weight gradient, plain or act), in bytes, as the
        source's launchers size it."""
        def stage(rows):
            return _cdiv(rows * (self.wb + 2) * 2 * self.pg * esz, 16) * 16
        ns = NSTAGE_ACT if act else NSTAGE
        if not wgrad:
            return ns * stage(self.r + 2)
        ring = ns * (stage(self.r + 2) + stage(self.r))
        return max(ring, 4 * 27 * self.wb * 2 * self.pg)


def _strips(b: int, t: int, h: int, w: int, c: int, smem=None,
            pg_max: int | None = None, nt: int = NT_MAX) -> PlanS1:
    """Rows, columns and channel pairs of a row-strip split of ``(B, T, h,
    w, C)``, over the whole clip.  Columns first: all ``w`` in one block
    where ``w`` ≤ ``nt`` (256 threads unless given; so at least two where
    ``w`` is: the stride-1 kernels stage the halo columns with the threads
    of columns 0 and 1), then as many channel pairs as fill ``nt`` threads,
    in equal groups.  With ``pg_max``, channel pairs first: equal groups of
    at most ``pg_max`` pairs, then as many columns as fill ``nt`` threads,
    in equal tiles.  The
    pairs are cut into more groups while ``smem(plan, 4)``, the block's f32
    shared memory, would pass the card's limit.  Rows: strips of 2 to 4, of
    equal height (rows past ``h`` read the zero padding)."""
    p2 = _cdiv(c, 2)
    if pg_max is None:
        wb = _cdiv(w, _cdiv(w, nt))
        pg = _cdiv(p2, _cdiv(p2, max(1, nt // wb)))
    else:
        pg = _cdiv(p2, _cdiv(p2, pg_max))
        wb = _cdiv(w, _cdiv(w, nt // pg))
    r = max(RMIN, _cdiv(h, _cdiv(h, RMAX)))
    plan = PlanS1(b, t, h, w, c, r, wb, pg, t, 1, 1)
    while smem is not None and smem(plan, 4) > SMEM_MAX and plan.pg > 1:
        plan = _narrower(plan)  # wide C
    return plan


def _narrower(plan: PlanS1) -> PlanS1:
    """``plan`` with its channel pairs cut into one more group of equal
    size, or into groups one pair narrower where that leaves the count of
    groups as it was."""
    p2 = _cdiv(plan.c, 2)
    return plan._replace(pg=min(plan.pg - 1, _cdiv(p2, plan.n_pg + 1)))


def _split_frames(plan: PlanS1, blocks: int) -> PlanS1:
    """``plan`` with the clip halved into segments (down to 8 frames)
    until it has ``blocks`` tiles."""
    tt = plan.t
    while tt > TT_MIN and plan._replace(tt=tt).items * plan.n_pg < blocks:
        tt = max(TT_MIN, _cdiv(tt, 2))
    return plan._replace(tt=tt)


@lru_cache(maxsize=None)
def plan_s1(b: int, t: int, h: int, w: int, c: int) -> PlanS1:
    """The work split of the stride-1 kernels for x ``(B, T, H, W, C)``:
    :func:`_strips` over ``(H, W)``, frames split until the forward has two
    waves of blocks.  The weight gradient walks the same items, ``ipb`` per
    block, on about two blocks per SM."""
    return _persistent(_split_frames(_strips(b, t, h, w, c), FWD_BLOCKS))


def _persistent(plan: PlanS1) -> PlanS1:
    """``plan`` with a weight gradient's persistent grid: ``ipb`` items per
    block, on about two blocks per SM."""
    ipb = _cdiv(plan.items, max(1, min(plan.items, WG_BLOCKS // plan.n_pg)))
    return plan._replace(ipb=ipb, rows=_cdiv(plan.items, ipb))


# ---- the stride-2 kernels' work splits -----------------------------------------

GSTAGE = 5  # g frames in the stride-2 dx kernels' shared-memory ring
XSTAGE = 3  # x frames in the stride-2 act dx kernel's ring
DX_PG = 32  # channel pairs per group at most in the stride-2 dx
NT_DX = 192  # threads per block at most in the masked dx (168 registers)


@lru_cache(maxsize=None)
def plan_s2_fwd(b: int, t: int, h: int, w: int, c: int) -> PlanS1:
    """The work split of ``dw_conv_s2`` (K4 plain) for x ``(B, T, H, W,
    C)``: :func:`_strips` over the output ``(⌈H/2⌉, ⌈W/2⌉)`` (its ``h``/``w``
    and tiles are output rows and columns) with the f32 shared memory of
    :func:`smem_s2_fwd`, frames split until there are two waves of blocks
    at two per SM.  A block stages the 2R+1 input rows and 2WB+1 input
    columns its output tile reads."""
    ho, wo = _out_hw(h, w, 2)
    return _split_frames(_strips(b, t, ho, wo, c, smem_s2_fwd), FWD_BLOCKS)


@lru_cache(maxsize=None)
def plan_act_s2_fwd(b: int, t: int, h: int, w: int, c: int) -> PlanS1:
    """The work split of ``dw_act_s2`` (K4 act, K4 plain's body with the
    act ring) for x ``(B, T, H, W, C)``: :func:`plan_s2_fwd`'s rule with
    the f32 shared memory of the act ring, ``NSTAGE_ACT`` frames deep
    (:func:`smem_s2_fwd` with ``act``)."""
    ho, wo = _out_hw(h, w, 2)
    return _split_frames(
        _strips(b, t, ho, wo, c, lambda p, esz: smem_s2_fwd(p, esz, True)),
        FWD_BLOCKS)


@lru_cache(maxsize=None)
def plan_s2_dx(b: int, t: int, h: int, w: int, c: int) -> PlanS1:
    """The work split of ``dw_conv_dx_s2`` (K8) for dx ``(B, T, H, W, C)``:
    :func:`_strips` over g ``(⌈H/2⌉, ⌈W/2⌉)`` (its ``h``/``w`` and tiles
    are g's rows and columns; g row i, column j owns dx rows 2i, 2i+1 and
    columns 2j, 2j+1 inside ``(H, W)``), channel pairs first in groups of
    at most ``DX_PG`` (a warp's dx stores are then runs of 54-62 channels
    at the path's widths, whole pixels where C ≤ 64), with the f32 shared
    memory of :func:`smem_s2_dx`, frames split as :func:`plan_s2_fwd`
    splits them.  A block stages R+1 g rows at WB+1 g columns."""
    ho, wo = _out_hw(h, w, 2)
    return _split_frames(_strips(b, t, ho, wo, c, smem_s2_dx, DX_PG),
                         FWD_BLOCKS)


@lru_cache(maxsize=None)
def plan_act_dx_s2(b: int, t: int, h: int, w: int, c: int) -> PlanS1:
    """The work split of ``dw_act_dx_s2`` (K5, K8's body with K3's
    epilogue) for x ``(B, T, H, W, C)``: :func:`plan_s2_dx`'s rule over g
    ``(⌈H/2⌉, ⌈W/2⌉)`` (channel pairs first in groups of at most ``DX_PG``)
    with at most ``NT_DX`` threads (the epilogue's registers) and the f32
    shared memory of :func:`smem_act_dx_s2`, frames split as
    :func:`plan_s2_fwd` splits them.  One block per item and channel group,
    so ``rows`` (= items) is its partial buffer's row count."""
    ho, wo = _out_hw(h, w, 2)
    plan = _split_frames(_strips(b, t, ho, wo, c, smem_act_dx_s2, DX_PG,
                                 NT_DX), FWD_BLOCKS)
    return plan._replace(ipb=1, rows=plan.items)


@lru_cache(maxsize=None)
def plan_s2(b: int, t: int, h: int, w: int, c: int) -> PlanS1:
    """The work split of both stride-2 weight gradients,
    ``dw_conv_wgrad_s2`` (K10 plain) and ``dw_act_wgrad_s2`` (K10 act), for
    x ``(B, T, H, W, C)``: :func:`_strips` over the output ``(⌈H/2⌉,
    ⌈W/2⌉)`` with the f32 shared memory of the act mode's larger ring
    (:func:`smem_s2`), and frames split only until the persistent grid has
    about two blocks per SM.  Each item stages the 2R+1 input rows and 2WB+1
    input columns its output tile reads."""
    ho, wo = _out_hw(h, w, 2)
    return _persistent(_split_frames(
        _strips(b, t, ho, wo, c, lambda p, esz: smem_s2(p, esz, True)),
        WG_BLOCKS))


# ---- the stride-(2, 2, 2) kernels' work splits -------------------------------

# steps of x frames in flight in dw_conv_t2, and its ring's frames (a
# step's two, two a step in flight)
T2F_AHEAD = 1
T2F_SLOTS = 2 * (T2F_AHEAD + 1)
GSTAGE_T2 = 4  # g frames in dw_conv_dx_t2's ring


def _t2(t: int) -> int:
    """Output frames of ``t`` at temporal stride 2."""
    return (t - 1) // 2 + 1


def _pairs_first(c: int) -> int:
    """Channel pairs a group of the t2 kernels holds at most: the whole
    pixel where it has at most ``T2_WHOLE_PG`` pairs (C = 54 and 108 on the
    path), else ``DX_PG``."""
    p2 = _cdiv(c, 2)
    return p2 if p2 <= T2_WHOLE_PG else DX_PG


def _t2_xslot(plan: PlanS1, esz: int) -> int:
    """Bytes of one staged x frame of the t2 forward and weight gradient:
    2R+1 rows, de-interleaved pairs or, in the whole-pixel modes, the tile's
    2WB+1 pixels from a 16-byte boundary, whichever is larger."""
    row = 2 * (plan.wb + 1) * 2 * plan.pg
    whole = 16 * ((2 * plan.wb + 1) * 2 * plan.pg * esz // 16 + 2)
    return max(_pad16((2 * plan.r + 1) * row * esz), (2 * plan.r + 1) * whole)


def smem_t2_fwd(plan: PlanS1, esz: int) -> int:
    """Dynamic shared memory per block of ``dw_conv_t2``, in bytes, as its
    launcher sizes it: ``T2F_SLOTS`` x frames (:func:`_t2_xslot`) and an
    8-byte mbarrier each."""
    return T2F_SLOTS * (_t2_xslot(plan, esz) + 8)


@lru_cache(maxsize=None)
def plan_t2_fwd(b: int, t: int, h: int, w: int, c: int) -> PlanS1:
    """The work split of ``dw_conv_t2`` for x ``(B, T, H, W, C)``:
    :func:`_strips` over the output's ``(B, ⌈T/2⌉, ⌈H/2⌉, ⌈W/2⌉, C)`` (its
    ``t``, ``tt`` and tiles are output frames) with the channel pairs first
    (:func:`_pairs_first`: the whole pixel in one group at C = 54 and 108,
    where the kernel stages whole pixels), then columns to fill the block,
    the f32 shared memory of :func:`smem_t2_fwd`, frames split until there
    are two waves of blocks at two per SM.  A block stages the 2TT+1 input
    frames its outputs read, two a step."""
    ho, wo = _out_hw(h, w, 2)
    return _split_frames(_strips(b, _t2(t), ho, wo, c, smem_t2_fwd,
                                 _pairs_first(c)), FWD_BLOCKS)


def t2_whole(plan: PlanS1, t: torch.Tensor) -> bool:
    """The mode a t2 wrapper launches its kernel in: the whole-pixel mode
    (the forward's bulk copies of x's rows, the dx's tile written out as
    runs, the weight gradient's 16-byte copies of x's rows) where ``plan``'s
    channel group is the pixel and the rows of ``t`` (x, or the dx written)
    are 16-byte aligned, else each thread's channel pairs.  The launchers
    refuse a whole-pixel mode where this does not hold."""
    return (plan.n_pg == 1 and 2 * plan.pg == plan.c
            and t.data_ptr() % 16 == 0
            and t.shape[3] * plan.c * t.element_size() % 16 == 0)


def _t2_tileb(plan: PlanS1, esz: int) -> int:
    """Bytes of one dx row of ``dw_conv_dx_t2``'s tile (2WB pixels of the
    group from a 16-byte boundary, one chunk of slack)."""
    return 16 * (2 * plan.wb * 2 * plan.pg * esz // 16 + 2)


def smem_t2_dx(plan: PlanS1, esz: int) -> int:
    """Dynamic shared memory per block of ``dw_conv_dx_t2``, in bytes, as its
    launcher sizes it: :func:`smem_s2_dx`'s g frames, ``GSTAGE_T2`` deep,
    and two dx tiles of 2R rows."""
    return (GSTAGE_T2 * _pad16((plan.r + 1) * (plan.wb + 1) * 2 * plan.pg
                               * esz)
            + 2 * 2 * plan.r * _t2_tileb(plan, esz))


@lru_cache(maxsize=None)
def plan_t2_dx(b: int, t: int, h: int, w: int, c: int) -> PlanS1:
    """The work split of ``dw_conv_dx_t2`` for dx ``(B, T, H, W, C)``:
    :func:`plan_s2_dx`'s rule over g ``(B, ⌈T/2⌉, ⌈H/2⌉, ⌈W/2⌉, C)`` (its
    ``t``, ``tt`` and tiles are g's frames; g frame j writes dx frames 2j
    and 2j+1) with whole-pixel groups up to ``T2_WHOLE_PG`` pairs
    (:func:`_pairs_first`: the kernel's tile mode writes whole rows of the
    block) and the shared memory of :func:`smem_t2_dx`."""
    ho, wo = _out_hw(h, w, 2)
    return _split_frames(_strips(b, _t2(t), ho, wo, c, smem_t2_dx,
                                 _pairs_first(c)), FWD_BLOCKS)


# channel pairs of a pixel that dw_conv_wgrad_t2 keeps in one group (its
# whole-pixel mode); wider pixels are cut into groups of at most DX_PG
T2_WHOLE_PG = 64
# x and g frames in its ring: a step's three and one, and the next step's
# two and one
T2_XSLOTS, T2_GSLOTS = 5, 2


def smem_t2(plan: PlanS1, esz: int) -> int:
    """Dynamic shared memory per block of ``dw_conv_wgrad_t2``, in bytes, as
    its launcher sizes it: ``T2_XSLOTS`` x frames (2R+1 rows, de-interleaved
    pairs or, in its whole-pixel mode, the tile's pixels from a 16-byte
    boundary, whichever is larger) and ``T2_GSLOTS`` g frames (R rows), or
    the column sums if larger."""
    ring = (T2_XSLOTS * _t2_xslot(plan, esz)
            + T2_GSLOTS * _pad16(plan.r * plan.wb * 2 * plan.pg * esz))
    return max(ring, 4 * 27 * plan.wb * 2 * plan.pg)


@lru_cache(maxsize=None)
def plan_t2(b: int, t: int, h: int, w: int, c: int) -> PlanS1:
    """The work split of ``dw_conv_wgrad_t2`` for x ``(B, T, H, W, C)``:
    :func:`_strips` over g ``(⌈T/2⌉, ⌈H/2⌉, ⌈W/2⌉)`` with the channel pairs
    first, all of a pixel in one group where they number at most
    ``T2_WHOLE_PG`` (the kernel's whole-pixel mode, 16-byte copies: C = 54
    and 108 on the path), else groups of at most ``DX_PG`` (runs of 54-62
    channels), and the f32 shared memory of :func:`smem_t2`; one segment a
    clip (``tt`` = ⌈T/2⌉: a block's items run as one stream of g frames),
    on the persistent grid of about two blocks per SM.  K10 plain
    (``dw_conv_wgrad_s2``) launched with this split and one segment of T
    frames has the same items and blocks."""
    ho, wo = _out_hw(h, w, 2)
    return _persistent(_strips(b, _t2(t), ho, wo, c, smem_t2,
                               _pairs_first(c)))


def _pad16(n: int) -> int:
    return _cdiv(n, 16) * 16


def smem_s2_fwd(plan: PlanS1, esz: int, act: bool = False) -> int:
    """Dynamic shared memory per block of ``dw_conv_s2`` (``act``:
    ``dw_act_s2``), in bytes, as its launcher sizes it: the ring of x
    frames (2R+1 rows of 2(WB+1) de-interleaved columns), ``NSTAGE`` deep
    (``act``: ``NSTAGE_ACT``)."""
    row = 2 * (plan.wb + 1) * 2 * plan.pg
    ns = NSTAGE_ACT if act else NSTAGE
    return ns * _pad16((2 * plan.r + 1) * row * esz)


def smem_s2_dx(plan: PlanS1, esz: int) -> int:
    """Dynamic shared memory per block of ``dw_conv_dx_s2``, in bytes, as
    its launcher sizes it: the ring of g frames (R+1 rows of WB+1
    columns)."""
    return GSTAGE * _pad16((plan.r + 1) * (plan.wb + 1) * 2 * plan.pg * esz)


def smem_act_dx_s2(plan: PlanS1, esz: int) -> int:
    """Dynamic shared memory per block of ``dw_act_dx_s2``, in bytes, as
    its launcher sizes it: :func:`smem_s2_dx`'s ring of g frames, then a
    ring of ``XSTAGE`` x frames (2R rows × 2WB own columns), or the column
    sums if larger."""
    xs = XSTAGE * _pad16(2 * plan.r * 2 * plan.wb * 2 * plan.pg * esz)
    return max(smem_s2_dx(plan, esz) + xs, 4 * 2 * plan.wb * 2 * plan.pg)


def smem_s2(plan: PlanS1, esz: int, act: bool = False) -> int:
    """Dynamic shared memory per block of ``dw_conv_wgrad_s2`` (``act``:
    ``dw_act_wgrad_s2``), in bytes, as its launcher sizes it: the ring of x
    frames (2R+1 de-interleaved rows) and g frames (R rows), ``NSTAGE``
    deep (``act``: ``NSTAGE_ACT``), or the column sums if larger."""
    ns = NSTAGE_ACT if act else NSTAGE
    row = 2 * (plan.wb + 1) * 2 * plan.pg
    ring = ns * (_pad16((2 * plan.r + 1) * row * esz)
                 + _pad16(plan.r * plan.wb * 2 * plan.pg * esz))
    return max(ring, 4 * 27 * plan.wb * 2 * plan.pg)


# ---- the stride-1 mm forward's work split (K1 mm, csrc/dw_mm_act.cu) ----------

XSTAGE = 3  # x frames in the mm kernels' staging ring (XSTAGE_MM)


MM_SETUP_FRAMES = 2  # a block's set-up (W1's columns, the taps), in frames


def _mm_ld_ng(plan: PlanS1, c_in: int, esz: int) -> tuple[int, int]:
    """The staged x row stride (bf16: C_in rounded up to 16, + 8: an odd
    multiple of 16 bytes) and W1's staged columns (bf16: ``2PG`` rounded up
    to 8) of the mm kernels."""
    if esz == 2:
        return _pad16(c_in) + 8, _cdiv(2 * plan.pg, 8) * 8
    return c_in, 2 * plan.pg


def _mm_front(plan: PlanS1, positions: int, c_in: int, esz: int,
              ring_min: int = 0) -> int:
    """Bytes of an mm kernel's shared memory from its x ring on, as
    ``mm_front`` lays it out: a ring of ``XSTAGE`` staged x frames of
    ``positions`` positions (rounded up to 16) × the row stride, at least
    ``ring_min`` bytes (a ring another phase reuses); W1's staged columns
    (bf16: ``ng`` × the row stride; f32: C_in × 2PG) and bn1's three
    vectors over them, each padded to 16 bytes; a table of the positions'
    places."""
    ld, ng = _mm_ld_ng(plan, c_in, esz)
    rows = _pad16(positions)
    wt = ng * ld * 2 if esz == 2 else c_in * 2 * plan.pg * 4
    return (max(XSTAGE * rows * ld * esz, ring_min) + _pad16(wt)
            + 3 * _pad16(ng * 4) + 4 * rows)


@lru_cache(maxsize=None)
def plan_mm_s1(b: int, t: int, h: int, w: int, c_in: int, c_mid: int,
               esz: int) -> PlanS1:
    """The work split of ``dw_mm_act_s1`` for x ``(B, T, H, W, C_in)`` of
    ``esz``-byte elements and ``C_mid`` output channels: :func:`plan_s1`'s
    rows, columns and channel pairs over the output ``(B, T, H, W,
    C_mid)``, the pairs cut into more groups where a block's shared memory
    (:func:`smem_mm_s1`, W1's columns are ``C_in`` deep) would pass the
    card's limit; and the mm kernels' frame segments
    (:func:`_mm_segments`)."""
    base = plan_s1(b, t, h, w, c_mid)
    p2 = _cdiv(c_mid, 2)
    n_pg = base.n_pg
    while smem_mm_s1(base, c_in, esz) > SMEM_MAX and base.pg > 1:
        n_pg += 1
        base = base._replace(pg=_cdiv(p2, n_pg))
    return _mm_segments(base)._replace(ipb=1, rows=1)


def _mm_segments(plan: PlanS1) -> PlanS1:
    """``plan`` with the mm kernels' frame segments: a segment of ``tt``
    frames stages and multiplies ``tt + 2`` input frames, and the blocks
    run in rounds of two per SM, so ``tt`` (equal segments, down to 1
    frame) minimises rounds × (``tt`` + 2 + ``MM_SETUP_FRAMES``); ties go
    to the longer segment."""
    best = None
    for n in range(1, plan.t + 1):
        tt = _cdiv(plan.t, n)
        blocks = plan._replace(tt=tt).items * plan.n_pg
        cost = _cdiv(blocks, 2 * SMS) * (tt + 2 + MM_SETUP_FRAMES)
        if best is None or cost < best[0]:
            best = (cost, tt)
    return plan._replace(tt=best[1])


def smem_mm_s1(plan: PlanS1, c_in: int, esz: int) -> int:
    """Dynamic shared memory per block of ``dw_mm_act_s1``, in bytes, as its
    launcher sizes it (``mm_layout``): two activated slots
    ``[R+2][WB+2][2PG]``, then :func:`_mm_front`'s layout of ``(R+2) ·
    min(WB+2, W)`` staged positions."""
    aslot = _pad16((plan.r + 2) * (plan.wb + 2) * 2 * plan.pg * esz)
    return 2 * aslot + _mm_front(
        plan, (plan.r + 2) * min(plan.wb + 2, plan.w), c_in, esz)


# ---- the stride-1 mm weight gradient's work split (K6 mm, dw_plain_s1.cu) -----

@lru_cache(maxsize=None)
def plan_mm_wgrad_s1(b: int, t: int, h: int, w: int, c_in: int, c_mid: int,
                     esz: int) -> PlanS1:
    """The work split of ``dw_mm_wgrad_s1`` (K6 mm) for x ``(B, T, H, W,
    C_in)`` of ``esz``-byte elements and g ``(B, T, H, W, C_mid)``:
    :func:`plan_s1`'s rule over g at most ``NT_DX`` threads a block (the
    kernel's registers), the pairs cut into more groups where a block's
    shared memory (:func:`smem_mm_wgrad_s1`, W1's columns are ``C_in``
    deep) would pass the card's limit, then its frame segments and
    persistent grid.  K6 plain takes the same plan, and then walks each
    channel's items in K6 mm's order."""
    plan = _strips(b, t, h, w, c_mid, nt=NT_DX)
    while smem_mm_wgrad_s1(plan, c_in, esz) > SMEM_MAX and plan.pg > 1:
        plan = _narrower(plan)
    return _persistent(_split_frames(plan, FWD_BLOCKS))


def smem_mm_wgrad_s1(plan: PlanS1, c_in: int, esz: int) -> int:
    """Dynamic shared memory per block of ``dw_mm_wgrad_s1``, in bytes, as
    its launcher sizes it: :func:`smem_mm_s1`'s layout, then a ring of
    ``XSTAGE`` g frames ``[R][WB+2][2PG]``; or the column sums if
    larger."""
    g = XSTAGE * _pad16(plan.r * (plan.wb + 2) * 2 * plan.pg * esz)
    return max(smem_mm_s1(plan, c_in, esz) + g,
               4 * 27 * plan.wb * 2 * plan.pg)


# ---- the stride-1 dx's work splits (K3 and K2, csrc/dw_dx_s1.cu) -------------

TT_MM = 32   # frames per segment at most in K2 (a mask slot each)


def smem_dx_s1(plan: PlanS1, c_in: int, esz: int, mm: bool) -> int:
    """Dynamic shared memory per block of ``dw_act_dx_s1`` (``mm`` false)
    or ``dw_mm_dx_mask_s1``, in bytes, as their launcher sizes it
    (``dx_layout``).  act: a ring of three slots, each a g frame ``[R+2]
    [WB+2][2PG]`` and an x frame ``[R][WB+2][2PG]`` (reused for the column
    sums).  mm (``mm_mask_layout``): :func:`_mm_front`'s layout of ``R ·
    min(WB, W)`` staged positions, its ring at least three g frames; a mask
    slot ``[R][WB][2PG]`` of bytes for each of the ``tt`` frames."""
    pg2 = 2 * plan.pg
    gstage = _pad16((plan.r + 2) * (plan.wb + 2) * pg2 * esz)
    if not mm:
        ring = NSTAGE * (gstage + _pad16(plan.r * (plan.wb + 2) * pg2 * esz))
        return max(ring, 4 * 2 * plan.wb * pg2)
    return (_mm_front(plan, plan.r * min(plan.wb, plan.w), c_in, esz,
                      NSTAGE * gstage)
            + plan.tt * _pad16(plan.r * plan.wb * pg2))


def _dx_s1_split(b: int, t: int, h: int, w: int, c: int, smem,
                 tt_max: int) -> PlanS1:
    """The split of the stride-1 dx of ``(B, T, h, w, C)``: :func:`_strips`
    with channel pairs first in groups of at most ``DX_PG`` (so a warp's
    loads and stores are runs of whole pixels at the path's widths) and at
    most ``NT_DX`` threads, segments of at most ``tt_max`` frames, the
    pairs cut into more groups while ``smem(plan)``, the block's shared
    memory, would pass the card's limit; frames split further until there
    are two waves of blocks at two per SM.  One block per item and channel
    group, so ``rows`` (= items) is the partial buffer's row count."""
    plan = _strips(b, t, h, w, c, pg_max=DX_PG, nt=NT_DX)
    plan = plan._replace(tt=min(t, tt_max))
    while smem(plan) > SMEM_MAX and plan.pg > 1:
        plan = _narrower(plan)
    plan = _split_frames(plan, FWD_BLOCKS)
    plan = plan._replace(tt=min(plan.tt, tt_max))
    return plan._replace(ipb=1, rows=plan.items)


@lru_cache(maxsize=None)
def plan_act_dx_s1(b: int, t: int, h: int, w: int, c: int) -> PlanS1:
    """The work split of ``dw_act_dx_s1`` (K3) for x ``(B, T, H, W, C)``:
    :func:`_dx_s1_split` with the act kernel's shared memory (f32, the
    larger), any segment length.  Its partial-sum buffer has ``rows``
    rows."""
    return _dx_s1_split(b, t, h, w, c,
                        lambda p: smem_dx_s1(p, c, 4, False), t)


@lru_cache(maxsize=None)
def plan_mm_dx_s1(b: int, t: int, h: int, w: int, c_in: int, c_mid: int,
                  esz: int) -> PlanS1:
    """The work split of ``dw_mm_dx_mask_s1`` (K2) for x ``(B, T, H, W,
    C_in)`` of ``esz``-byte elements and ``C_mid`` channels of g:
    :func:`_dx_s1_split` over ``(B, T, H, W, C_mid)`` with the mm kernel's
    shared memory at ``esz`` and segments of at most ``TT_MM`` frames."""
    return _dx_s1_split(b, t, h, w, c_mid,
                        lambda p: smem_dx_s1(p, c_in, esz, True), TT_MM)


# ---- the stride-2 mm kernels' work splits (K4 mm, K9, K10 mm; dw_plain_s2.cu) --

# an SM's shared memory on the H100: a block's limit and the 1 KB the
# runtime keeps for each block
SMEM_SM = SMEM_MAX + 1024
# a block's shared memory where two fit on an SM (each also takes 1 KB)
SMEM_PAIR = SMEM_SM // 2 - 1024


def smem_mm_s2_fwd(plan: PlanS1, c_in: int, esz: int, w: int) -> int:
    """Dynamic shared memory per block of ``dw_mm_act_s2`` (K4 mm) for x
    of width ``w``, in bytes, as its launcher sizes it
    (``mm_s2_fwd_layout``): two activated slots in K4 plain's staged-frame
    layout (2R+1 rows of 2(WB+1) de-interleaved columns), then
    :func:`_mm_front`'s layout of ``(2R+1) · min(2WB+1, W)`` staged
    positions."""
    aslot = _pad16((2 * plan.r + 1) * 2 * (plan.wb + 1) * 2 * plan.pg * esz)
    return 2 * aslot + _mm_front(
        plan, (2 * plan.r + 1) * min(2 * plan.wb + 1, w), c_in, esz)


def smem_mm_dx_s2(plan: PlanS1, c_in: int, esz: int, w: int) -> int:
    """Dynamic shared memory per block of ``dw_mm_dx_mask_s2`` (K9) for x
    of width ``w``, in bytes, as its launcher sizes it (``mm_s2_dx_layout``):
    :func:`_mm_front`'s layout of ``2R · min(2WB, W)`` staged positions,
    its ring at least ``GSTAGE`` g frames (:func:`smem_s2_dx`); a mask slot
    ``[2R][2][WB][2PG]`` of bytes for each of the ``tt`` frames."""
    mask = _pad16(2 * plan.r * 2 * plan.wb * 2 * plan.pg)
    return (_mm_front(plan, 2 * plan.r * min(2 * plan.wb, w), c_in, esz,
                      smem_s2_dx(plan, esz))
            + plan.tt * mask)


def smem_mm_wgrad_s2(plan: PlanS1, c_in: int, esz: int, w: int) -> int:
    """Dynamic shared memory per block of ``dw_mm_wgrad_s2`` (K10 mm) for x
    of width ``w``, in bytes, as its launcher sizes it
    (``mm_s2_wgrad_smem``): :func:`smem_mm_s2_fwd`'s layout, then a ring of
    ``XSTAGE`` g frames ``[R][WB][2PG]``; or the column sums if larger."""
    g = XSTAGE * _pad16(plan.r * plan.wb * 2 * plan.pg * esz)
    return max(smem_mm_s2_fwd(plan, c_in, esz, w) + g,
               4 * 27 * plan.wb * 2 * plan.pg)


def _mm_s2_tiles(b: int, t: int, h: int, w: int, c_mid: int, smem) -> PlanS1:
    """The tiles of the stride-2 mm kernels that stage x's rectangle over
    the output (K4 mm, K10 mm): :func:`_strips` over the output ``(⌈H/2⌉,
    ⌈W/2⌉)``, channel pairs first in groups of at most ``DX_PG`` (each
    group stages all of x's C_in, so wide groups stage it fewer times) and
    at most ``NT_DX`` threads (the product's registers beside the stencil's).
    While ``smem(plan)``, the block's shared memory, would keep two blocks
    off an SM, the strips lose a row (down to ``RMIN``), then the column
    tiles narrow, then the pairs are cut into more groups."""
    ho, wo = _out_hw(h, w, 2)
    plan = _strips(b, t, ho, wo, c_mid, pg_max=DX_PG, nt=NT_DX)
    while smem(plan) > SMEM_PAIR:
        if plan.r > RMIN:
            plan = plan._replace(r=plan.r - 1)
        elif plan.wb > 2:
            plan = plan._replace(wb=_cdiv(wo, _cdiv(wo, plan.wb - 1)))
        elif plan.pg > 1:
            plan = _narrower(plan)
        else:
            break
    return plan


@lru_cache(maxsize=None)
def plan_mm_s2_fwd(b: int, t: int, h: int, w: int, c_in: int, c_mid: int,
                   esz: int) -> PlanS1:
    """The work split of ``dw_mm_act_s2`` (K4 mm) for x ``(B, T, H, W,
    C_in)`` of ``esz``-byte elements and ``C_mid`` output channels:
    :func:`_mm_s2_tiles` with its shared memory (:func:`smem_mm_s2_fwd`)
    and the mm kernels' frame segments (:func:`_mm_segments`)."""
    return _mm_segments(_mm_s2_tiles(
        b, t, h, w, c_mid, lambda p: smem_mm_s2_fwd(p, c_in, esz, w)))._replace(
            ipb=1, rows=1)


@lru_cache(maxsize=None)
def plan_mm_wgrad_s2(b: int, t: int, h: int, w: int, c_in: int, c_mid: int,
                     esz: int) -> PlanS1:
    """The work split of ``dw_mm_wgrad_s2`` (K10 mm, K4 mm's product on K10
    plain's walk) for x ``(B, T, H, W, C_in)`` of ``esz``-byte elements and
    g ``(B, T, ⌈H/2⌉, ⌈W/2⌉, C_mid)``: :func:`_mm_s2_tiles` with its shared
    memory (:func:`smem_mm_wgrad_s2`: x's rectangle of 2R+1 rows and 2WB+1
    columns, all C_in, three frames deep, does not fit :func:`plan_s2`'s
    full-width tiles), the mm kernels' frame segments (:func:`_mm_segments`:
    each segment multiplies two frames more than it has) and
    :func:`plan_s2`'s persistent grid.  K10 plain takes the same plan, and
    then walks each channel's items in K10 mm's order."""
    return _persistent(_mm_segments(_mm_s2_tiles(
        b, t, h, w, c_mid, lambda p: smem_mm_wgrad_s2(p, c_in, esz, w))))


@lru_cache(maxsize=None)
def plan_mm_dx_s2(b: int, t: int, h: int, w: int, c_in: int, c_mid: int,
                  esz: int) -> PlanS1:
    """The work split of ``dw_mm_dx_mask_s2`` (K9, K8's body with K2's mask
    phase) for x ``(B, T, H, W, C_in)`` of ``esz``-byte elements and
    ``C_mid`` channels of g: :func:`plan_act_dx_s2`'s rule over g
    ``(⌈H/2⌉, ⌈W/2⌉)`` (channel pairs first in groups of at most ``DX_PG``,
    at most ``NT_DX`` threads, frames split until there are two waves of
    blocks at two per SM), then shorter equal segments while the masks (a
    slot per frame of a segment) would keep two blocks off an SM
    (:func:`smem_mm_dx_s2`), then, were one frame still too many, the pairs
    cut into more groups.  One block per item and channel group."""
    ho, wo = _out_hw(h, w, 2)
    plan = _split_frames(_strips(b, t, ho, wo, c_mid, pg_max=DX_PG,
                                 nt=NT_DX), FWD_BLOCKS)
    while smem_mm_dx_s2(plan, c_in, esz, w) > SMEM_PAIR and plan.tt > 1:
        # the longest equal segments shorter than these
        plan = plan._replace(tt=_cdiv(t, _cdiv(t, plan.tt - 1)))
    while smem_mm_dx_s2(plan, c_in, esz, w) > SMEM_PAIR and plan.pg > 1:
        plan = _narrower(plan)
    return plan._replace(ipb=1, rows=plan.items)


# ---- forward: the plain mode of K1 (stride 1) and K4 (stride 2) -------------

def _stride(stride):
    """``stride`` as the kernels take it: 1 or 2 (``(1, s, s)``), or
    ``T2``; raises on any other."""
    s3 = strides3(stride)
    if s3 == T2:
        return T2
    if s3 in ((1, 1, 1), (1, 2, 2)):
        return s3[1]
    raise ValueError(f"stride must be 1, 2 (i.e. (1,2,2)) or (2,2,2), got "
                     f"{stride}")


def dw_conv3d_plain(x: torch.Tensor, w_dw: torch.Tensor,
                    stride) -> torch.Tensor:
    """The 27-tap depthwise sum of x, zero-padded by one on T, H and W, in
    f32 at stride ``(1, s, s)`` (or ``T2``), written in x's dtype."""
    return stencil_f32(x, w_dw, stride).to(x.dtype)


# ---- the work of each kernel's function (its roofline bound; the count of
# ``utils.hw.program_costs``): x (or dx), g (or y) and the taps moved once,
# the f32 taps' gradient written once; 27 taps a g (or y) element

def fwd_work(y, x, w_dw, stride) -> Work:
    """:func:`dw_conv3d`'s work, ``y`` its output."""
    return Work((x.numel() + y.numel() + w_dw.numel()) * x.element_size(),
                2 * 27 * y.numel())


def dx_work(dx, g, w_dw, hw) -> Work:
    """:func:`dw_conv_dx_s2`'s and :func:`dw_conv_dx_t2`'s work, ``dx``
    the output."""
    return Work((dx.numel() + g.numel() + w_dw.numel()) * g.element_size(),
                2 * 27 * g.numel())


def wgrad_work(dk, x, g, stride) -> Work:
    """:func:`dw_conv_wgrad`'s work, ``dk`` its output."""
    return Work((x.numel() + g.numel()) * x.element_size()
                + 27 * x.shape[-1] * 4, 2 * 27 * g.numel())


@kernel_work(fwd_work)
def dw_conv3d(x: torch.Tensor, w_dw: torch.Tensor, stride) -> torch.Tensor:
    """Depthwise 3³ conv at stride ``(1, s, s)`` or ``T2`` with SAME zero
    padding.

    Args:
      x: ``(B, T, H, W, C)`` float32 or bfloat16, contiguous.
      w_dw: ``(3, 3, 3, C)`` depthwise taps in x's dtype.
      stride: 1, or 2 for stride (1, 2, 2), or ``T2`` = (2, 2, 2).

    Returns ``(B, T, ⌈H/s⌉, ⌈W/s⌉, C)`` (``T2``: ``(B, ⌈T/2⌉, ...)``) in x's
    dtype.  A CPU tensor takes :func:`dw_conv3d_plain`; a CUDA tensor
    launches ``dw_conv_s1``, ``dw_conv_s2`` or ``dw_conv_t2``, or raises."""
    stride = _stride(stride)
    _check(x, w_dw, None, None, 2 if stride == T2 else stride)
    if x.device.type == "cpu":
        return dw_conv3d_plain(x, w_dw, stride)
    b, t, h, w, c = x.shape
    to = _t2(t) if stride == T2 else t
    y = torch.empty((b, to) + _out_hw(h, w, 2 if stride == T2 else stride)
                    + (c,), dtype=x.dtype, device=x.device)
    if not y.numel():
        return y
    lib, plan, name = {1: (LIBRARY, plan_s1, "dw_conv_s1"),
                       2: (LIBRARY_S2, plan_s2_fwd, "dw_conv_s2"),
                       T2: (LIBRARY_S2, plan_t2_fwd, "dw_conv_t2")}[stride]
    p = plan(b, t, h, w, c)
    whole = (int(t2_whole(p, x)),) if stride == T2 else ()
    _launch(LAUNCHES, lib, name, x, x.data_ptr(), w_dw.data_ptr(),
            y.data_ptr(), b, t, h, w, c, p.r, p.wb, p.pg, p.tt, *whole)
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


@kernel_work(dx_work)
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
        p = plan_s2_dx(*shape)
        _launch(LAUNCHES, LIBRARY_S2, "dw_conv_dx_s2", g, g.data_ptr(),
                w_dw.data_ptr(), dx.data_ptr(), *shape, p.r, p.wb, p.pg, p.tt)
    return dx


# ---- dx at stride (2, 2, 2) ----------------------------------------------------------

def dw_conv_dx_t2_plain(g: torch.Tensor, w_dw: torch.Tensor,
                        thw: tuple[int, int, int]) -> torch.Tensor:
    """dx of :func:`dw_conv3d` at ``T2``: the correlation of g placed at the
    even frames, rows and columns of a zero ``(B, T, H, W, C)`` tensor (``thw
    = (T, H, W)``) with the flipped taps, in f32, written in g's dtype."""
    b, _, _, _, c = g.shape
    up = torch.zeros((b,) + tuple(thw) + (c,), dtype=torch.float32,
                     device=g.device)
    up[:, ::2, ::2, ::2] = g.float()
    return stencil_f32(up, torch.flip(w_dw, (0, 1, 2)), 1).to(g.dtype)


@kernel_work(dx_work)
def dw_conv_dx_t2(g: torch.Tensor, w_dw: torch.Tensor,
                  thw: tuple[int, int, int]) -> torch.Tensor:
    """dx of :func:`dw_conv3d` at ``T2``: ``g (B, ⌈T/2⌉, ⌈H/2⌉, ⌈W/2⌉, C)``
    → ``(B, T, H, W, C)`` with ``thw = (T, H, W)`` (see
    :func:`dw_conv_dx_t2_plain`).  A CPU tensor takes the plain version; a
    CUDA tensor launches ``dw_conv_dx_t2``, or raises."""
    _check(g, w_dw, None, None, 1)
    t, h, w = thw
    if tuple(g.shape[1:4]) != (_t2(t),) + _out_hw(h, w, 2):
        raise ValueError(f"g's T, H, W {tuple(g.shape[1:4])} are not those "
                         f"of stride (2, 2, 2) from {tuple(thw)}")
    if g.device.type == "cpu":
        return dw_conv_dx_t2_plain(g, w_dw, thw)
    shape = (g.shape[0], t, h, w, g.shape[-1])
    dx = torch.empty(shape, dtype=g.dtype, device=g.device)
    if dx.numel():
        p = plan_t2_dx(*shape)
        _launch(LAUNCHES, LIBRARY_S2, "dw_conv_dx_t2", g, g.data_ptr(),
                w_dw.data_ptr(), dx.data_ptr(), *shape, p.r, p.wb, p.pg, p.tt,
                int(t2_whole(p, dx)))
    return dx


# ---- wgrad: the plain mode of K6 (stride 1) and K10 (stride 2) -------------------

def dw_conv_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                        stride) -> torch.Tensor:
    """``dk[tap, c] = Σ_pos x_pad[s·pos + tap]·g[pos]`` in f32 (``s`` the
    stride triple): ``(27, C)``."""
    return wgrad_f32(x, g, stride)


@kernel_work(wgrad_work)
def dw_conv_wgrad(x: torch.Tensor, g: torch.Tensor,
                  stride) -> torch.Tensor:
    """Weight gradient of :func:`dw_conv3d` (see :func:`dw_conv_wgrad_plain`),
    ``(27, C)`` f32.  A CPU tensor takes the plain version; a CUDA tensor
    launches ``dw_conv_wgrad_s1``, ``dw_conv_wgrad_s2`` or
    ``dw_conv_wgrad_t2`` (per-block partial sums, added with one
    ``torch.sum``), or raises."""
    stride = _stride(stride)
    if stride == T2:
        _check(x, None, None, None, 2)
        want = (x.shape[0], _t2(x.shape[1])) + _out_hw(
            *x.shape[2:4], 2) + (x.shape[-1],)
        if tuple(g.shape) != want or g.dtype != x.dtype:
            raise ValueError(f"g must be {x.dtype} {want}, got {g.dtype} "
                             f"{tuple(g.shape)}")
        _check(g, None, None, None, 1)
        if g.device != x.device:
            raise ValueError(f"g is on {g.device}, x on {x.device}")
    else:
        _check(x, None, None, None, stride, g)
    if x.device.type == "cpu":
        return dw_conv_wgrad_plain(x, g, stride)
    if not g.numel():
        return torch.zeros((27, x.shape[-1]), device=x.device)
    if stride == T2:
        p = plan_t2(*x.shape)
        part = torch.empty((p.rows, 27, x.shape[-1]), dtype=torch.float32,
                           device=x.device)
        _launch(LAUNCHES, LIBRARY_S2, "dw_conv_wgrad_t2", x, x.data_ptr(),
                g.data_ptr(), part.data_ptr(), *x.shape, p.r, p.wb, p.pg,
                p.tt, p.ipb, p.rows, int(t2_whole(p, x)))
    elif stride == 1:
        p = plan_s1(*x.shape)
        part = torch.empty((p.rows, 27, x.shape[-1]), dtype=torch.float32,
                           device=x.device)
        _launch(LAUNCHES, LIBRARY, "dw_conv_wgrad_s1", x, x.data_ptr(),
                g.data_ptr(), part.data_ptr(), *x.shape, p.r, p.wb, p.pg,
                p.tt, p.ipb, p.rows)
    else:
        p = plan_s2(*x.shape)
        part = torch.empty((p.rows, 27, x.shape[-1]), dtype=torch.float32,
                           device=x.device)
        _launch(LAUNCHES, LIBRARY_S2, "dw_conv_wgrad_s2", x, x.data_ptr(),
                g.data_ptr(), part.data_ptr(), *x.shape, p.r, p.wb, p.pg,
                p.tt, p.ipb, p.rows)
    return torch.sum(part, dim=0)


# ---- autograd ---------------------------------------------------------------------

class DwConv3d(torch.autograd.Function):
    """:func:`dw_conv3d` with the kernels' backward (the JAX package's
    ``_dw_fold4_bwd`` and ``_dw_s2_bwd``; at ``T2`` XLA's transpose of
    ``_lax_conv``): at stride 1 dx is :func:`dw_conv3d` of g with the flipped
    taps, at stride 2 :func:`dw_conv_dx_s2`, at ``T2``
    :func:`dw_conv_dx_t2`; the taps' gradient is :func:`dw_conv_wgrad`,
    returned in the taps' dtype.  ``stride``: 1, 2 or a triple
    (:func:`_stride`)."""

    @staticmethod
    def forward(ctx, x, w_dw, stride):
        stride = _stride(stride)
        ctx.stride = stride
        ctx.save_for_backward(x, w_dw)
        return dw_conv3d(x, w_dw, stride)

    @staticmethod
    def backward(ctx, g):
        x, w_dw = ctx.saved_tensors
        g = g.contiguous()
        if ctx.stride == 1:
            dx = dw_conv3d(g, torch.flip(w_dw, (0, 1, 2)).contiguous(), 1)
        elif ctx.stride == T2:
            dx = dw_conv_dx_t2(g, w_dw, x.shape[1:4])
        else:
            dx = dw_conv_dx_s2(g, w_dw, x.shape[2:4])
        dk = dw_conv_wgrad(x, g, ctx.stride)
        return dx, dk.reshape(3, 3, 3, -1).to(w_dw.dtype), None


# ``dw_conv3d_train(x, w_dw, stride)``: :func:`dw_conv3d` inside autograd
dw_conv3d_train = DwConv3d.apply
