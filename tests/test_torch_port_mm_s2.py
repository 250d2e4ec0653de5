"""The stride-2 mm kernels on the row-strip layout (``csrc/dw_plain_s2.cu``):
K4 ``mm`` (``dw_mm_act_s2``, ``mm_s2_fwd_kernel``: K1 ``mm``'s product on K4
plain's back end) and K9 (``dw_mm_dx_mask_s2``, ``mm_s2_dx_kernel``: K8's
body with K2's mask phase).  The kernels run only on the card, where
``chip_smoke.py`` holds each against its exact oracle and its plain
version; here:

* ``plan_mm_s2_fwd`` covers every output element once and
  ``plan_mm_dx_s2`` every dx element once (through g's tiles and the 2×2
  quads they own), at the path's entry shapes and at ragged ones, within
  the kernels' limits, each fitting two blocks per SM in bf16 and f32; a
  plan narrows its strips, then its column tiles, then its pairs (K4
  ``mm``) or shortens its segments (K9) only as far as two blocks need;
* a model of the positions' tables (``MmRect::table`` with the kernels'
  place functions) maps every staged position inside the frame to one
  place and the halo outside to -1: K4 ``mm``'s places are those K4 plain's
  ``S2Stager`` stages the same input columns at, and the stencil's reads
  (``s2_frame``) find each output's three columns there; K9's places are
  those its epilogue reads each dx quad's branch at;
* K4 ``mm``'s plain version is held against the JAX Pallas kernel in
  interpret mode at stride 2 (``dw_fold4_mm_act``'s forward; K9's is held
  in ``test_torch_port_mm_train_kernels.py``, the bindings of both in
  ``test_torch_port_plain_s2.py``);
* the kernels share ``mm_strip.cuh``'s staging, product and mask phase.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coarse_fine_networks_tpu.ops.fold import (fold_pad, fold_pointwise_kernel,
                                               from_fold4, pad_vec, to_fold4)
from coarse_fine_networks_tpu.ops.pallas.dw_fold import (
    fold_dw_mm_bnrelu_conv3d)
from coarse_fine_networks_torch.ops import dw_conv
from coarse_fine_networks_torch.ops.dw_conv import (
    DX_PG, NT_DX, RMAX, RMIN, SMEM_MAX, SMEM_PAIR, SMEM_SM, plan_mm_dx_s2,
    plan_mm_s2_fwd, smem_mm_dx_s2, smem_mm_s2_fwd)
from coarse_fine_networks_torch.ops.dw_mm_act import (
    dw_mm_bnrelu_conv3d_plain)

from _torch_port_util import t

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)

# x (B, T, H, C_in) and C_mid of the stride-2 entries: the serve run (B3:
# the fine tower at T128, the coarse tower at T64 in layer1 and T17 after
# Grid Pool), and the B8 steps (train_mm's coarse step at T64 / T17, the
# fine eval step and long-cycle phase D at T64)
PATH = [(3, 128, 112, 24, 54), (3, 128, 56, 24, 108), (3, 128, 28, 48, 216),
        (3, 128, 14, 96, 432), (3, 64, 112, 24, 54), (3, 17, 56, 24, 108),
        (3, 17, 28, 48, 216), (3, 17, 14, 96, 432), (8, 64, 112, 24, 54),
        (8, 17, 56, 24, 108), (8, 17, 28, 48, 216), (8, 17, 14, 96, 432),
        (8, 64, 56, 24, 108), (8, 64, 28, 48, 216), (8, 64, 14, 96, 432)]
# (B, T, H, W, C_in, C_mid): odd sizes, one column, a width split into
# column tiles, odd and narrow C_mid, and the 64² request's layer3 and
# layer4 (2×2 and 4×4 outputs)
RAGGED = [(1, 3, 7, 6, 16, 12), (2, 5, 5, 9, 8, 13), (3, 1, 1, 1, 8, 1),
          (1, 3, 4, 300, 8, 6), (2, 9, 9, 9, 16, 7), (1, 32, 8, 8, 48, 216),
          (1, 32, 4, 4, 96, 432), (2, 8, 7, 7, 96, 432)]
SHAPES = [(b, tt, h, h, ci, cm) for b, tt, h, ci, cm in PATH] + RAGGED
IDS = ["x".join(map(str, s)) for s in SHAPES]


def _cdiv(a, b):
    return -(-a // b)


def _partitions(spans, n):
    """The distinct spans ``(lo, hi)`` tile ``[0, n)`` with no overlap."""
    spans = sorted(set(spans))
    return (spans[0][0] == 0 and spans[-1][1] == n
            and all(a[1] == b[0] and a[0] < a[1] for a, b in
                    zip(spans, spans[1:])) and spans[-1][0] < spans[-1][1])


def _covers_once(p, dims, to_full=None):
    """Every (sample, frame, row, column, channel) of ``dims`` is owned by
    exactly one (item, channel group) of plan ``p``: ``tile`` decomposes an
    item into independent indices, so the tiles are the product of their
    spans per axis; each axis's spans partition it and the tiles are all
    distinct.  ``to_full`` maps a span of the plan's rows (columns) to the
    span of the tensor it owns (K9: g row i owns dx rows 2i, 2i + 1)."""
    tiles = set()
    axes = [[] for _ in range(5)]
    for item in range(p.items):
        for g in range(p.n_pg):
            b, ts, hs, ws, cs = p.tile(item, g)
            if to_full:
                hs, ws = to_full(hs, dims[2]), to_full(ws, dims[3])
            tile = ((b, b + 1), ts, hs, ws, cs)
            assert tile not in tiles
            tiles.add(tile)
            for a, span in zip(axes, tile):
                a.append(span)
    assert len(tiles) == np.prod([len(set(a)) for a in axes])
    return all(_partitions(a, n) for a, n in zip(axes, dims))


def _fits_two(smem):
    return smem <= SMEM_PAIR and 2 * smem <= SMEM_MAX and (
        2 * (smem + 1024) <= SMEM_SM)


def _limits(p, wo):
    assert RMIN <= p.r <= RMAX and p.wb * p.pg <= NT_DX
    assert p.threads <= NT_DX and p.pg <= DX_PG
    assert p.wb <= wo and (p.wb >= 2 or wo == 1)
    assert p.pg <= _cdiv(p.c, 2) and 1 <= p.tt <= p.t


@pytest.mark.parametrize("esz", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_fwd_plan_covers_every_output_once(shape, esz):
    """K4 ``mm``'s split: every output element once, within the kernel's
    limits, two blocks per SM; a strip is shorter, a column tile narrower or
    a channel group narrower than the pairs-first split only where the wider
    one would not fit two blocks; the segments minimise the modelled rounds
    × frames."""
    b, tt, h, w, c_in, c = shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    p = plan_mm_s2_fwd(b, tt, h, w, c_in, c, esz)
    _limits(p, wo)
    assert _fits_two(smem_mm_s2_fwd(p, c_in, esz, w))
    base = dw_conv._strips(b, tt, ho, wo, c, pg_max=DX_PG, nt=NT_DX)
    if (p.r, p.wb, p.pg) != (base.r, base.wb, base.pg):
        assert smem_mm_s2_fwd(base, c_in, esz, w) > SMEM_PAIR
    if p.r < base.r and p.r < RMAX:  # one row more would not fit
        taller = p._replace(r=p.r + 1, wb=base.wb, pg=base.pg)
        assert smem_mm_s2_fwd(taller, c_in, esz, w) > SMEM_PAIR

    def cost(seg):
        blocks = p._replace(tt=seg).items * p.n_pg
        return _cdiv(blocks, 2 * dw_conv.SMS) * (
            seg + 2 + dw_conv.MM_SETUP_FRAMES)
    assert cost(p.tt) == min(cost(_cdiv(tt, n)) for n in range(1, tt + 1))
    assert _covers_once(p, (b, tt, ho, wo, c))


@pytest.mark.parametrize("esz", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_dx_plan_covers_every_dx_element_once(shape, esz):
    """K9's split over g: every dx element once (g row i and column j own dx
    rows 2i, 2i + 1 and columns 2j, 2j + 1 inside (H, W)), within the
    kernel's limits, two blocks per SM with a mask slot per frame; the
    segments are ``plan_act_dx_s2``'s, shortened only as far as the masks
    need."""
    b, tt, h, w, c_in, c = shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    p = plan_mm_dx_s2(b, tt, h, w, c_in, c, esz)
    _limits(p, wo)
    assert _fits_two(smem_mm_dx_s2(p, c_in, esz, w))
    act = dw_conv._split_frames(dw_conv._strips(
        b, tt, ho, wo, c, pg_max=DX_PG, nt=NT_DX), dw_conv.FWD_BLOCKS)
    assert (p.r, p.wb) == (act.r, act.wb) and p.tt <= act.tt
    if p.tt < act.tt:  # the next longer equal segments did not fit
        longer = min(act.tt, _cdiv(tt, p.n_tseg - 1))
        assert smem_mm_dx_s2(p._replace(tt=longer), c_in, esz,
                             w) > SMEM_PAIR
    assert p.rows == p.items and p.ipb == 1
    assert _covers_once(p, (b, tt, h, w, c),
                        lambda s, n: (2 * s[0], min(2 * s[1], n)))


def test_layer4_f32_forward_takes_shorter_strips():
    """At layer4 (14² → 7², C_in 96, C_mid 432) the f32 forward's staged x
    rectangles and W1's columns would keep two blocks of 4-row strips off
    an SM: its strips are 2 rows; bf16 keeps 4."""
    assert plan_mm_s2_fwd(8, 17, 14, 14, 96, 432, 2).r == 4
    assert plan_mm_s2_fwd(8, 17, 14, 14, 96, 432, 4).r == RMIN


def test_layer1_dx_masks_shorten_the_segments():
    """At layer1 (112² → 56², C 54, T 64) a mask slot is 2R·2WB·2PG = 6,048
    bytes a frame: 64 frames would not fit beside the ring, so K9's
    segments are cut to the longest equal ones that leave two blocks per
    SM, in each dtype."""
    for esz in (2, 4):
        p = plan_mm_dx_s2(8, 64, 112, 112, 24, 54, esz)
        assert p.tt < 64 and _fits_two(smem_mm_dx_s2(p, 24, esz, 112))
        assert p.tt == _cdiv(64, p.n_tseg)  # equal segments
        longer = p._replace(tt=_cdiv(64, p.n_tseg - 1))
        assert smem_mm_dx_s2(longer, 24, esz, 112) > SMEM_PAIR


# ---- the positions' tables (MmRect::table, csrc/mm_strip.cuh) ---------------

def _rect(r0, nr, c0, nc, h, w):
    """``MmRect``'s clipped rectangle: (cs0, ncs, M, rlo, rhi); the product
    reads the M positions up to the frame's last row."""
    cs0 = max(c0, 0)
    ncs = min(c0 + nc, w) - cs0
    rhi = min(nr, h - r0)
    return cs0, ncs, rhi * ncs, max(0, -r0), rhi


def _table(rect, rows, place):
    """``MmRect::table``: each staged position's place, -1 outside the
    frame or past M."""
    cs0, ncs, m, rlo, _ = rect
    tab = []
    for p in range(rows):
        rr = p // ncs
        tab.append(place(rr, cs0 + p - rr * ncs)
                   if p < m and rr >= rlo else -1)
    return tab


def _fwd_tables(p, h, w):
    """K4 ``mm``'s table of every tile of plan ``p``, with the tile:
    ``mm_s2_fwd_kernel``'s rectangle (input rows 2h0 - 1 .., 2R + 1 of
    them, columns 2w0 - 1 .., 2WB + 1) and place function (row rr of the
    slot, the even column e/2 or the odd column (e - 1)/2 of input column
    2w0 - 1 + e)."""
    pg2, rowlen = 2 * p.pg, 2 * (p.wb + 1) * 2 * p.pg
    rows = _cdiv((2 * p.r + 1) * min(2 * p.wb + 1, w), 16) * 16
    for item in range(p.items):
        _, _, (h0, _), (w0, _), _ = p.tile(item, 0)
        e0 = 2 * w0 - 1
        rect = _rect(2 * h0 - 1, 2 * p.r + 1, e0, 2 * p.wb + 1, h, w)

        def place(rr, col, e0=e0):
            e = col - e0
            return rr * rowlen + ((e & 1) * (p.wb + 1) + (e >> 1)) * pg2
        yield (h0, w0), rect, _table(rect, rows, place)


@pytest.mark.parametrize("shape", [(1, 2, 14, 14, 96, 432),
                                   (1, 2, 28, 28, 48, 216),
                                   (2, 3, 7, 6, 16, 12),
                                   (1, 2, 5, 9, 8, 13),
                                   (1, 1, 1, 1, 8, 1),
                                   (1, 2, 4, 300, 8, 6)])
def test_fwd_table_places_the_frame_once_and_the_halo_nowhere(shape):
    """Every staged position inside the frame has one place in the
    activated slot, the halo outside and the rows past M have -1; each
    place is where K4 plain's ``S2Stager`` stages that input column
    (``dstE`` at even e = 2wl, ``dstO`` at odd e = 2wl + 1, ``dstX`` at e =
    2WB), so ``s2_frame``'s reads of output column w0 + wl (``atE``,
    ``atO``, ``atE + PG2``) find input columns 2(w0 + wl) - 1 + dx."""
    b, tt, h, w, c_in, c = shape
    for esz in (2, 4):
        p = plan_mm_s2_fwd(b, tt, h, w, c_in, c, esz)
        pg2, rowlen = 2 * p.pg, 2 * (p.wb + 1) * 2 * p.pg
        for (h0, w0), rect, tab in _fwd_tables(p, h, w):
            cs0, ncs, _, _, _ = rect
            want = {}
            for rr in range(2 * p.r + 1):
                if not 0 <= 2 * h0 - 1 + rr < h:
                    continue
                for col in range(max(2 * w0 - 1, 0),
                                 min(2 * w0 + 2 * p.wb, w)):
                    want[(rr, col)] = None
            placed = [v for v in tab if v >= 0]
            assert len(placed) == len(set(placed)) == len(want)
            for i, v in enumerate(tab):
                if v < 0:
                    continue
                rr, col = i // ncs, cs0 + i % ncs
                assert (rr, col) in want
                assert 0 <= v < (2 * p.r + 1) * rowlen
                # S2Stager's places of the same input column
                e = col - (2 * w0 - 1)
                wl = e // 2
                stager = (rr * rowlen + wl * pg2 if e % 2 == 0 and wl < p.wb
                          else rr * rowlen + (p.wb + 1) * pg2 + wl * pg2
                          if e % 2 else rr * rowlen + p.wb * pg2)
                assert v == stager
                want[(rr, col)] = v
            for wl in range(p.wb):  # the stencil's three columns
                at_e = wl * pg2
                at_o = (p.wb + 1) * pg2 + at_e
                for dx, at in enumerate((at_e, at_o, at_e + pg2)):
                    col = 2 * (w0 + wl) - 1 + dx
                    for rr in range(2 * p.r + 1):
                        if (rr, col) in want:
                            assert want[(rr, col)] == rr * rowlen + at


@pytest.mark.parametrize("shape", [(1, 2, 112, 112, 24, 54),
                                   (1, 2, 14, 14, 96, 432),
                                   (2, 3, 7, 6, 16, 12),
                                   (1, 2, 5, 9, 8, 13),
                                   (1, 1, 1, 1, 8, 1)])
def test_dx_table_places_where_the_epilogue_reads(shape):
    """K9's table (``mm_masks`` on x rows 2h0 .. 2h0 + 2R, columns
    2w0 .. 2w0 + 2WB, no halo) puts each in-frame position's branches at
    one place of its mask slot ``[2R][2][WB][2PG]``, inside the slot, and
    exactly where the epilogue reads dx row 2(h0 + r) + py, column 2j + px
    (``((2r + py)·2 + px)·WB·2PG + wl·2PG``)."""
    b, tt, h, w, c_in, c = shape
    for esz in (2, 4):
        p = plan_mm_dx_s2(b, tt, h, w, c_in, c, esz)
        pg2 = 2 * p.pg
        mbytes = _cdiv(2 * p.r * 2 * p.wb * pg2, 16) * 16
        rows = _cdiv(2 * p.r * min(2 * p.wb, w), 16) * 16
        for item in range(p.items):
            _, _, (h0, _), (w0, _), _ = p.tile(item, 0)
            rect = _rect(2 * h0, 2 * p.r, 2 * w0, 2 * p.wb, h, w)

            def place(rr, col, w0=w0):
                e = col - 2 * w0
                return ((rr * 2 + (e & 1)) * p.wb + (e >> 1)) * pg2
            tab = _table(rect, rows, place)
            placed = [v for v in tab if v >= 0]
            assert len(placed) == len(set(placed))
            assert all(0 <= v and v + pg2 <= mbytes for v in placed)
            reads = {}
            for r in range(p.r):
                for py in range(2):
                    for wl in range(p.wb):
                        for px in range(2):
                            row, col = 2 * (h0 + r) + py, 2 * (w0 + wl) + px
                            if row < h and col < w:
                                reads[(row, col)] = (((2 * r + py) * 2 + px)
                                                     * p.wb * pg2 + wl * pg2)
            cs0, ncs = rect[0], rect[1]
            got = {(2 * h0 + i // ncs, cs0 + i % ncs): v
                   for i, v in enumerate(tab) if v >= 0}
            assert got == reads


# ---- the plain versions against the JAX Pallas kernels -------------------------

def _inputs(shape, c_mid, seed):
    rng = np.random.RandomState(seed)
    c_in = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    w1 = (rng.randn(c_in, c_mid) / np.sqrt(c_in)).astype(np.float32)
    k = (rng.randn(3, 3, 3, c_mid) / np.sqrt(27)).astype(np.float32)
    sc = (rng.rand(c_mid) + 0.5).astype(np.float32)
    bi = rng.randn(c_mid).astype(np.float32)
    bi[: c_mid // 2] = -np.abs(bi[: c_mid // 2]) - 0.5  # negative: zero frame
    return x, w1, k, sc, bi


def _fold_w1(w1):
    c_in, c = w1.shape
    return fold_pointwise_kernel(jnp.asarray(w1).reshape(1, 1, 1, c_in, c),
                                 c_in, c)


@pytest.mark.parametrize("shape,c_mid", [((1, 3, 16, 8, 16), 12),
                                         ((1, 2, 8, 16, 8), 20)])
def test_fwd_plain_matches_pallas_interpret(shape, c_mid):
    """K4 ``mm``'s plain version against ``_fwd_s2_direct_pcall``'s mm mode
    in interpret mode, at C_mid = 12 and 20 (no multiple of 8 or 32)."""
    x, w1, k, sc, bi = _inputs(shape, c_mid, seed=sum(shape) + c_mid)
    p = fold_pad(c_mid)
    y = fold_dw_mm_bnrelu_conv3d(
        to_fold4(jnp.asarray(x)), _fold_w1(w1),
        jnp.asarray(k).reshape(3, 3, 3, 1, c_mid),
        pad_vec(jnp.asarray(sc), c_mid, p), pad_vec(jnp.asarray(bi), c_mid, p),
        c_mid, 2, impl="interpret")
    ref = np.asarray(from_fold4(y, c_mid))
    got = dw_mm_bnrelu_conv3d_plain(t(x), t(w1), t(k), t(sc), t(bi), 2)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# ---- the shared code ------------------------------------------------------------

def test_kernels_share_the_mm_product_and_the_plain_bodies():
    """K4 ``mm`` stages its rectangle (``MmRect``) and activates through
    ``mm_activate`` (``mm_strip_product``, K1 ``mm``'s product) into the
    slot ``s2_frame`` reads; K9 is ``dx_s2_body``'s mm instantiation, its
    masks from K2's phase (``mm_masks``: ``MmRect``'s staging and
    ``mm_strip_product``); K1 ``mm`` and K6 ``mm`` stage through ``MmRect``
    too, so the header keeps one staging; the constants the plans mirror are
    the sources', and an SM's shared memory is a block's limit and the 1 KB
    the runtime keeps for it."""
    src = dw_conv.LIBRARY_S2.source.read_text()
    csrc = dw_conv.LIBRARY_S2.source.parent
    head = (csrc / "mm_strip.cuh").read_text()
    assert '#include "mm_strip.cuh"' in src and "struct MmRect" in head
    assert "MmTile" not in head
    fwd = src[src.index("mm_s2_fwd_kernel(const T*"):]
    fwd = fwd[:fwd.index("\n}\n")]
    for name in ("MmRect mr(", "mm_activate<T>(", "s2_frame<T, R>(",
                 "mm_band("):
        assert name in fwd
    masks = head[head.index("void mm_masks("):]
    masks = masks[:masks.index("\n}\n")]
    assert "mm_strip_product<T>(" in masks and "mr.stage(" in masks
    body = src[src.index("void dx_s2_body("):]
    body = body[:body.index("\n}\n")]
    assert "MmRect mr(" in body and "mm_masks<T>(" in body
    assert "dx_s2_body<T, R, false, true>(" in src
    dx1 = (csrc / "dw_dx_s1.cu").read_text()
    assert "mm_masks<T>(" in dx1 and "cp_async16(" not in dx1
    for f in ("dw_mm_act.cu", "dw_plain_s1.cu"):
        assert "MmRect mt(" in (csrc / f).read_text(), f
    text = src + (csrc / "strip.cuh").read_text() + head
    for name, value in (("NT_DX", NT_DX), ("XSTAGE_MM", dw_conv.XSTAGE),
                        ("GSTAGE", dw_conv.GSTAGE), ("SMEM_MAX", SMEM_MAX)):
        m = re.search(r"constexpr int %s = (\d+);" % name, text)
        assert m and int(m.group(1)) == value, name
    assert SMEM_SM == SMEM_MAX + 1024 == 228 * 1024
    assert SMEM_PAIR == SMEM_SM // 2 - 1024
