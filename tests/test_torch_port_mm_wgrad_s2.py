"""The stride-2 mm weight gradient on the row-strip layout (K10 ``mm``:
``dw_mm_wgrad_s2``, ``mm_s2_wgrad_kernel`` in ``csrc/dw_plain_s2.cu``, K4
``mm``'s product on K10 plain's walk).  The kernel runs only on the card,
where ``chip_smoke.py`` holds it against its exact oracle (K10 plain
launched with its plan on K1 ``mm``'s activation) and its plain version;
here:

* ``plan_mm_wgrad_s2`` covers every g element once at the stride-2 entry
  shapes of the coarse train step and of long-cycle phases A-D and at
  ragged ones, in bf16 and f32: at most ``NT_DX`` threads, two blocks per
  SM, channel pairs covering C_mid, block rows covering the items, and a
  plan K10 plain takes unchanged (the exact oracle launches it);
* a torch model of the kernel's walk (:func:`mm_walk_model`: each frame's
  activation put into a slot by K4 ``mm``'s table, read as ``s2_frame``
  reads it, summed under ``wgrad_slots``' rule) equals
  ``dw_mm_wgrad_plain(…, 2)`` in f32 with ragged strips, ragged column
  tiles and frame segments, and puts NaN where it does with x's NaN on the
  clip's and the frame's edges;
* the source builds the kernel from those pieces, and the entry is bound
  as declared.  (``dw_mm_wgrad_plain`` at stride 2 is held against the
  interpreted JAX ``_wgrad_s2_raw`` in
  ``test_torch_port_mm_train_kernels.py``.)
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from coarse_fine_networks_torch.ops import dw_conv
from coarse_fine_networks_torch.ops.dw_conv import (
    DX_PG, NT_DX, NT_MAX, RMAX, RMIN, SMEM_MAX, SMEM_PAIR, SMEM_SM,
    plan_mm_wgrad_s2, smem_mm_wgrad_s2, smem_s2)
from coarse_fine_networks_torch.ops.dw_mm_act import dw_mm_wgrad_plain

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _cdiv(a, b):
    return -(-a // b)


def _entries():
    """x (B, T, H, C_in) and C_mid of every stride-2 bottleneck entry: the
    coarse train step (B8, T64 in layer1, T17 after Grid Pool) and
    long-cycle phases A-D (B64 T16 112², B32 T32 144², B16 T32 224², B8
    T64 224²: the stem halves the crop, each stage's block 0 halves it
    again)."""
    stages = ((24, 54), (24, 108), (48, 216), (96, 432))
    coarse = dict(zip((112, 56, 28, 14), (64, 17, 17, 17)))
    for (h, t), (c_in, c_mid) in zip(coarse.items(), stages):
        yield 8, t, h, c_in, c_mid
    for b, t, crop in ((64, 16, 112), (32, 32, 144), (16, 32, 224),
                       (8, 64, 224)):
        h = (crop - 1) // 2 + 1
        for c_in, c_mid in stages:
            yield b, t, h, c_in, c_mid
            h = (h - 1) // 2 + 1


PATH = sorted(set(_entries()))
# (B, T, H, W, C_in, C_mid): odd sizes, one column, a width split into
# column tiles, odd and narrow C_mid
RAGGED = [(1, 3, 7, 6, 16, 12), (2, 5, 5, 9, 8, 13), (3, 1, 1, 1, 8, 1),
          (1, 3, 4, 300, 8, 6), (2, 9, 9, 9, 16, 7), (2, 8, 7, 7, 96, 432)]
SHAPES = [(b, t, h, h, ci, cm) for b, t, h, ci, cm in PATH] + RAGGED
IDS = ["x".join(map(str, s)) for s in SHAPES]


def _partitions(spans, n):
    """The distinct spans ``(lo, hi)`` tile ``[0, n)`` with no overlap."""
    spans = sorted(set(spans))
    return (spans[0][0] == 0 and spans[-1][1] == n
            and all(a[1] == b[0] and a[0] < a[1] for a, b in
                    zip(spans, spans[1:])) and spans[-1][0] < spans[-1][1])


@pytest.mark.parametrize("esz", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plan_covers_every_g_element_once(shape, esz):
    """K10 ``mm``'s split over g: every (sample, frame, row, column,
    channel) owned by one (item, channel group), at most ``NT_DX`` threads
    and two blocks per SM; the block rows of each channel group cover its
    items, each row with at least one; the pairs cover C_mid; K10 plain's
    launcher takes the same plan (its ring fits, its threads are within
    ``NT_MAX``); the tiles are K4 ``mm``'s rule's with this kernel's memory
    and the segments minimise the modelled rounds × frames."""
    b, t, h, w, c_in, c = shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    p = plan_mm_wgrad_s2(b, t, h, w, c_in, c, esz)
    assert (p.h, p.w, p.c) == (ho, wo, c)
    assert RMIN <= p.r <= RMAX and p.threads <= NT_DX and p.pg <= DX_PG
    assert p.wb <= wo and (p.wb >= 2 or wo == 1) and 1 <= p.tt <= t
    smem = smem_mm_wgrad_s2(p, c_in, esz, w)
    assert smem <= SMEM_PAIR and 2 * (smem + 1024) <= SMEM_SM
    assert smem_s2(p, esz) <= SMEM_MAX and p.wb * p.pg <= NT_MAX
    assert p.n_pg * p.pg >= _cdiv(c, 2) > (p.n_pg - 1) * p.pg
    assert p.rows * p.ipb >= p.items > (p.rows - 1) * p.ipb
    base = dw_conv._strips(b, t, ho, wo, c, pg_max=DX_PG, nt=NT_DX)
    if (p.r, p.wb, p.pg) != (base.r, base.wb, base.pg):
        assert smem_mm_wgrad_s2(base, c_in, esz, w) > SMEM_PAIR

    def cost(seg):
        blocks = p._replace(tt=seg).items * p.n_pg
        return _cdiv(blocks, 2 * dw_conv.SMS) * (
            seg + 2 + dw_conv.MM_SETUP_FRAMES)
    assert cost(p.tt) == min(cost(_cdiv(t, n)) for n in range(1, t + 1))
    tiles, axes = set(), [[] for _ in range(5)]
    for item in range(p.items):
        for g in range(p.n_pg):
            bb, ts, hs, ws, cs = p.tile(item, g)
            tile = ((bb, bb + 1), ts, hs, ws, cs)
            assert tile not in tiles
            tiles.add(tile)
            for a, span in zip(axes, tile):
                a.append(span)
    assert len(tiles) == np.prod([len(set(a)) for a in axes])
    assert all(_partitions(a, n) for a, n in zip(axes, (b, t, ho, wo, c)))


def test_layer1_tiles_are_pairs_first():
    """At layer1 (112² → 56², C_in 24, C_mid 54) the columns-first tiles of
    ``plan_s2`` (56 columns) would stage an x rectangle of 113 columns
    three frames deep, past a block's shared memory at any row count above
    the minimum: the plan takes K4 ``mm``'s pairs-first tiles, all 27 pairs
    of C_mid in one group."""
    for esz in (2, 4):
        p = plan_mm_wgrad_s2(8, 64, 112, 112, 24, 54, esz)
        assert p.n_pg == 1 and p.wb < 56
        wide = dw_conv.plan_s2(8, 64, 112, 112, 54)._replace(
            pg=1, r=RMAX, wb=56)
        assert smem_mm_wgrad_s2(wide, 24, esz, 112) > SMEM_PAIR


# ---- a torch model of the walk ----------------------------------------------------

def _activate(x, w1, sc, bi):
    return torch.relu(torch.matmul(x.float(), w1.float()) * sc + bi)


def mm_walk_model(x, w1, sc, bi, g, plan):
    """``dk (27, C)`` as ``mm_s2_wgrad_kernel`` sums it, in f32: for each of
    ``plan``'s items and each of its x frames i (frame t0 - 1 + i, in the
    clip), the frame's activation at the staged rectangle (input rows
    2h0 - 1 .. 2h0 + 2R - 1, columns 2w0 - 1 .. 2w0 + 2WB - 1, clipped to
    the frame: ``MmRect``) goes into a zeroed slot of 2R + 1 rows and
    2(WB + 1) columns at K4 ``mm``'s places (input column 2w0 - 1 + e at
    the even column e/2 or the odd column WB + 1 + (e - 1)/2); ring slot j
    holds g frame t0 - 2 + i + j, added only where it lies in the item's
    segment, for output rows below Ho and columns below Wo
    (``wgrad_slots``' rule); output column wl reads the slot's even
    column wl, odd column wl and even column wl + 1 (``s2_frame``), output
    row r staged row 2r + dy."""
    b_, t_, h_, w_, _ = x.shape
    ho, wo = g.shape[2:4]
    r_, wb = plan.r, plan.wb
    a = _activate(x, w1, sc, bi)
    c = a.shape[-1]
    dk = torch.zeros((27, c))
    for item in range(plan.items):
        b, (t0, t1), (h0, _), (w0, _), _ = plan.tile(item, 0)
        nf = t1 - t0 + 2
        r0, e0 = 2 * h0 - 1, 2 * w0 - 1
        rows = range(max(r0, 0), min(r0 + 2 * r_ + 1, h_))
        cols = range(max(e0, 0), min(e0 + 2 * wb + 1, w_))
        live = [wl for wl in range(wb) if w0 + wl < wo]
        for i in range(nf):
            ti = t0 - 1 + i
            if not 0 <= ti < t_:  # frames outside the clip add nothing
                continue
            slot = torch.zeros((2 * r_ + 1, 2 * (wb + 1), c))
            for rr in rows:
                for col in cols:
                    e = col - e0
                    slot[rr - r0, (e & 1) * (wb + 1) + (e >> 1)] = a[
                        b, ti, rr, col]
            for j in range(3):
                tg = ti - 1 + j
                if not t0 <= tg < t1:
                    continue
                for r in range(r_):
                    if h0 + r >= ho:
                        continue
                    gv = g[b, tg, h0 + r, [w0 + wl for wl in live]].float()
                    for dy in range(3):
                        for dx in range(3):
                            at = [(wl, wb + 1 + wl, wl + 1)[dx] for wl in live]
                            xs = slot[2 * r + dy, at]
                            dk[((2 - j) * 3 + dy) * 3 + dx] += torch.sum(
                                xs * gv, dim=0)
    return dk


# (B, T, H, W, C_in, C_mid), (tt, wb) overrides of the plan: frame
# segments and ragged column tiles; every strip set is ragged (Ho = 7 at R
# = 4, or odd H and W)
WALKS = [((2, 7, 14, 14, 8, 6), None), ((2, 7, 14, 14, 8, 6), (3, 3)),
         ((1, 5, 9, 11, 16, 5), (2, 2))]
WIDS = ["x".join(map(str, s)) + ("-plan" if o is None else "-split")
        for s, o in WALKS]
# (t, h, w) of x's NaN, at sample 1 (or 0), from (T, H, W)
EDGES = {"first_frame": lambda t, h, w: (0, h // 2, w // 2),
         "last_frame": lambda t, h, w: (t - 1, h // 2, w // 2),
         "last_row": lambda t, h, w: (t // 2, h - 1, w // 2),
         "last_column": lambda t, h, w: (t // 2, h // 2, w - 1)}


def _walk_case(shape, over, seed):
    rng = np.random.RandomState(seed)
    b, t, h, w, c_in, c = shape
    x = torch.from_numpy(rng.randn(b, t, h, w, c_in).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(c_in, c) / c_in ** 0.5).astype(
        np.float32))
    sc = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32))
    bi = torch.from_numpy(rng.randn(c).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, t, (h - 1) // 2 + 1, (w - 1) // 2 + 1,
                                   c).astype(np.float32))
    plan = plan_mm_wgrad_s2(b, t, h, w, c_in, c, 4)
    if over is not None:
        plan = plan._replace(tt=over[0], wb=over[1])
    assert plan.h % plan.r  # a ragged strip
    return x, w1, sc, bi, g, plan


@pytest.mark.parametrize("case", WALKS, ids=WIDS)
def test_walk_model_equals_the_plain_version(case):
    """On finite x the walk's sum is ``dw_mm_wgrad_plain``'s: the table's
    places and the stencil's reads give each tap the activation it pairs
    with, zero-padded after the activation."""
    x, w1, sc, bi, g, plan = _walk_case(*case, seed=3)
    torch.testing.assert_close(mm_walk_model(x, w1, sc, bi, g, plan),
                               dw_mm_wgrad_plain(x, w1, g, sc, bi, 2), **TOL)


@pytest.mark.parametrize("where", list(EDGES))
@pytest.mark.parametrize("case", WALKS, ids=WIDS)
def test_walk_model_puts_nan_where_the_plain_version_does(case, where):
    """x's NaN on the clip's first or last frame, the last row or the last
    column (conv1's input: it reaches every channel of its position): the
    walk's NaN taps are the plain version's, whose finite taps it
    matches."""
    x, w1, sc, bi, g, plan = _walk_case(*case, seed=4)
    b, t, h, w = x.shape[:4]
    x[(b - 1,) + EDGES[where](t, h, w) + (0,)] = float("nan")
    want = dw_mm_wgrad_plain(x, w1, g, sc, bi, 2)
    got = mm_walk_model(x, w1, sc, bi, g, plan)
    assert torch.isnan(want).any() and not torch.isnan(want).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    torch.testing.assert_close(got[fin], want[fin], **TOL)


# ---- the source ---------------------------------------------------------------------

def test_kernel_is_k4_mm_front_end_on_k10_plain_walk():
    """``mm_s2_wgrad_kernel`` stages x's rectangle (``MmRect``), puts the
    product through ``mm_activate`` at K4 ``mm``'s places, stages g by
    ``S2Stager::g_rows`` into a ring of its own, and sums with K10 plain's
    stencil (``s2_frame``, ``s2_frame_masked`` under ``wgrad_slots``) and
    partial rows (``wgrad_partials``), at most ``NT_DX`` threads; the
    entry launches it with the wrapper's plan."""
    src = dw_conv.LIBRARY_S2.source.read_text()
    body = src[src.index("mm_s2_wgrad_kernel(const T*"):]
    body = body[:body.index("\n}\n")]
    for name in ("MmRect mr(", "mm_activate<T>(", "sg.g_rows(",
                 "wgrad_slots(i - 1, nf)", "s2_frame<T, R>(",
                 "s2_frame_masked<T, R, true>(", "wgrad_partials(",
                 "mm_stage_w1<T>(", "nr = min(R, Ho - tl.h0);",
                 "live = in && tl.w0 + wl < Wo;",
                 "((e & 1) * (WB + 1) + (e >> 1)) * PG2"):
        assert name in body, name
    head = src[:src.index("mm_s2_wgrad_kernel(const T*")]
    assert head.rstrip().endswith("__global__ void __launch_bounds__(NT_DX, 2)")
    launch = src[src.index("int launch_mm_wgrad("):]
    launch = launch[:launch.index("\n}\n")]
    for name in ("WB * PG > NT_DX", "mm_s2_wgrad_smem<T>(", "rows * ipb",
                 "dim3(rows, p.n_pg)"):
        assert name in launch, name


@pytest.mark.parametrize("name", ["dw_mm_wgrad_s2",
                                  "dw_mm_wgrad_s2_occupancy"])
def test_entry_binding_matches_the_c_declaration(name):
    """A pointer for each ``void*``, an int for each ``int``, in order."""
    lib = dw_conv.LIBRARY_S2
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % name,
                  lib.source.read_text())
    assert m, name
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in m.group(1).split(",")]
    assert lib.functions[name] == want
