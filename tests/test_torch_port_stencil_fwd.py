"""K11's forward on channel vectors (``stencil_fwd_kernel`` in
``csrc/dw_stencil.cu``, ``dw_stencil_s1``): its work split, the order in
which it adds each output's taps, and its source.  The kernel runs only on
the card, where ``chip_smoke.py`` holds it against its plain version and,
at 3×3×3, against ``dw_conv_s1`` (K1 plain) with a difference of 0.

* A torch model of the kernel's walk: each thread's channel vector, pixel
  and frame segment (``plan_stencil_fwd``), the ring of x frames it copies
  into its own slots (a slot read must hold the frame the walk asks for:
  the halo of ``KT − 1`` frames a segment, nothing outside the clip or the
  frame copied), the register ring of the ``KT`` outputs a frame feeds and
  the store of each finished one.  Every output is written exactly once.
  With each term one fused multiply-add (the kernel's ``fmaf``: the f64
  sum of the f32 sum and the exact product, rounded to f32) the model
  equals ``dw_stencil3d_plain`` exactly; with an f32 product and an f32
  add it equals ``dw_conv3d_plain`` at 3×3×3 exactly.  A copy with the dy
  and dx loops swapped does not.
* ``plan_stencil_fwd`` against the source's ``fwd_plan`` (constants and
  steps), and its grid at every path's stem shape.
* The column-per-thread forward and the stride-2 instantiations are gone.

All f32; every comparison is exact (``torch.equal``)."""

import re

import numpy as np
import pytest
import torch

from coarse_fine_networks_torch.ops import dw_stencil
from coarse_fine_networks_torch.ops.dw_conv import dw_conv3d_plain
from coarse_fine_networks_torch.ops.dw_stencil import (FWD_BLOCKS,
                                                       WG_THREADS, WG_TT_MIN,
                                                       dw_stencil3d_plain,
                                                       plan_stencil_fwd)

from _torch_port_util import t

torch.set_num_threads(2)

SRC = dw_stencil.LIBRARY.source.read_text()


def _const(name: str) -> int:
    m = re.search(r"constexpr int %s = (\d+);" % name, SRC)
    assert m, name
    return int(m.group(1))


def _body(start: str) -> str:
    """The source from ``start`` to the end of its function."""
    s = SRC[SRC.index(start):]
    return s[:s.index("\n}\n")]


# ---- the walk ---------------------------------------------------------------

def fwd_walk_model(x, w, fused=True, swap=False):
    """y as ``stencil_fwd_kernel`` computes it, block by block and frame by
    frame, with the plan of ``plan_stencil_fwd``.  Thread ``tid`` of block
    ``(item, group)`` owns pixel ``item % npr · pp + tid // nvb`` and the
    channels ``(group · nvb + tid % nvb) · v ..`` (those below C) over the
    item's frames ``[t0, t1)``.  It copies x frame ``ti`` (each in-frame
    neighbour's vector) into ring slot ``(ti − ta) % FWD_DEPTH`` for ``ti``
    in the clip and below ``tb``, ``FWD_DEPTH − 1`` frames ahead of the one
    it sums; a neighbour outside the frame is not copied and reads as 0.
    While frame ``ti`` is summed, ``acc[j]`` is output ``ti − PT + j`` and
    takes tap ``dt = KT − 1 − j``, the neighbours in the order (dy, dx)
    (``swap``: (dx, dy)); then ``acc[0]`` is stored if it lies in the
    segment, and the ring shifts.  ``fused``: each term one fused
    multiply-add; else an f32 product, then an f32 add.  Asserts that every
    slot read holds the frame asked for and that every output is stored
    exactly once."""
    b, tn, h, wd, c = x.shape
    kt, ks = w.shape[0], w.shape[1]
    p = plan_stencil_fwd(b, tn, h, wd, c, kt, ks)
    depth = dw_stencil.FWD_DEPTH
    pt, ps, ns, hw = kt // 2, ks // 2, ks * ks, h * wd
    xf = x.float().reshape(b, tn, hw, c)
    wf = w.float().reshape(kt * ns, c)
    order = [dy * ks + dx for dy in range(ks) for dx in range(ks)]
    if swap:
        order = [dy * ks + dx for dx in range(ks) for dy in range(ks)]
    y = torch.full((b, tn, hw, c), float("nan"))
    stored = torch.zeros((b, tn, hw, c), dtype=torch.int64)
    tid = torch.arange(p.threads)
    for item in range(p.items):
        ts, bb = item // p.npr % p.n_tseg, item // p.npr // p.n_tseg
        t0 = ts * p.tt
        t1 = min(t0 + p.tt, tn)
        ta, tb = t0 - pt, t1 + pt
        pix = item % p.npr * p.pp + tid // p.nvb
        for cg in range(p.n_cg):
            ch = ((cg * p.nvb + tid % p.nvb)[:, None] * p.v
                  + torch.arange(p.v))
            live = (pix < hw) & (ch[:, 0] < c)  # threads that run
            pix_l, ch_l = pix[live], ch[live]
            own = ch_l < c  # the vector's channels that exist
            ch_c = ch_l.clamp(max=c - 1)
            nb = []  # each neighbour's pixel, -1 outside the frame
            for dy in range(ks):
                for dx in range(ks):
                    iy, ix = pix_l // wd + dy - ps, pix_l % wd + dx - ps
                    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
                    nb.append(torch.where(inside, iy * wd + ix, -1))
            taps = wf[:, ch_c]  # (taps, threads, v)
            ring = [None] * depth  # (frame, (ns, threads, v)) a slot

            def issue(ti):
                if 0 <= ti < tn and ti < tb:
                    vals = torch.full((ns, len(pix_l), p.v), float("nan"))
                    for s in range(ns):
                        inn = nb[s] >= 0
                        vals[s, inn] = torch.where(
                            own[inn], xf[bb, ti][nb[s][inn][:, None],
                                                 ch_c[inn]], 0.0)
                    ring[(ti - ta) % depth] = (ti, vals)

            acc = torch.zeros((kt, len(pix_l), p.v))
            for i in range(depth - 1):
                issue(ta + i)
            for ti in range(ta, tb):
                issue(ti + depth - 1)
                if 0 <= ti < tn:
                    frame, vals = ring[(ti - ta) % depth]
                    assert frame == ti, (frame, ti)
                    xv = [torch.where((nb[s] >= 0)[:, None], vals[s], 0.0)
                          for s in range(ns)]
                    for j in range(kt):
                        for s in order:
                            k = taps[(kt - 1 - j) * ns + s]
                            if fused:
                                acc[j] = (acc[j].double() + k.double()
                                          * xv[s].double()).float()
                            else:
                                acc[j] = acc[j] + k * xv[s]
                to = ti - pt
                if to >= t0:
                    rows, cols = own.nonzero(as_tuple=True)
                    y[bb, to, pix_l[rows], ch_l[rows, cols]] = acc[0][own]
                    stored[bb, to, pix_l[rows], ch_l[rows, cols]] += 1
                acc = torch.cat([acc[1:], torch.zeros_like(acc[:1])])
    assert (stored == 1).all(), "an output stored other than once"
    return y.reshape(b, tn, h, wd, c), p


def _xw(shape, ks, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(*ks, shape[-1]) / np.sqrt(np.prod(ks))).astype(np.float32)
    return t(x), t(w)


# (x shape, taps): the stem's 5×1×1 at C = 24 (a short last segment: 9 =
# 8 + 1 frames) and at C = 13 (a vector of 5 channels); 7×1×1 (vectors of
# 4); 3×3×3 and 1×3×3 (vectors of 2); 7×3×3 (vectors of 1, 8 pixels a
# block) and at C = 200 (two channel groups); ragged 7×7 and 5×9 frames at
# T = 17 (segments 8, 8, 1); a clip of five segments
WALK = [((2, 9, 5, 6, 24), (5, 1, 1)), ((2, 9, 5, 6, 13), (5, 1, 1)),
        ((1, 9, 4, 5, 24), (7, 1, 1)), ((1, 6, 5, 7, 10), (3, 3, 3)),
        ((1, 5, 6, 5, 24), (1, 3, 3)), ((1, 9, 4, 4, 24), (7, 3, 3)),
        ((1, 3, 2, 2, 200), (7, 3, 3)), ((2, 17, 7, 7, 24), (5, 1, 1)),
        ((1, 17, 5, 9, 24), (3, 3, 3)), ((1, 40, 3, 3, 24), (5, 1, 1))]
WALK_IDS = ["x".join(map(str, s)) + "-" + "x".join(map(str, k))
            for s, k in WALK]


@pytest.mark.parametrize("shape,ks", WALK, ids=WALK_IDS)
def test_walk_model_is_the_plain_version(shape, ks):
    """With fused adds the kernel's walk gives exactly what
    ``dw_stencil3d_plain`` gives (the card's oracle for K11 within
    ``TOL``), every output stored once, every slot read holding its frame."""
    x, w = _xw(shape, ks, seed=sum(shape) + sum(ks))
    got, p = fwd_walk_model(x, w)
    assert torch.equal(got, dw_stencil3d_plain(x, w)), p


def test_walk_cases_reach_every_rule():
    """The cases above split the clip (a short last segment, five
    segments), cut a vector short (C % V != 0), take two channel groups and
    each vector width of ``wg_vec``."""
    plans = {(s, k): plan_stencil_fwd(*s, k[0], k[1]) for s, k in WALK}
    assert {p.v for p in plans.values()} == {8, 4, 2, 1}
    assert plans[WALK[0]].n_tseg == 2 and 9 % plans[WALK[0]].tt == 1
    assert plans[WALK[-1]].n_tseg == 5
    assert plans[WALK[1]].v == 8 and 13 % 8
    assert plans[WALK[6]].n_cg == 2
    assert plans[WALK[7]].tt == WG_TT_MIN and plans[WALK[7]].n_tseg == 3


@pytest.mark.parametrize("shape", [(1, 6, 5, 7, 10), (2, 5, 4, 6, 54)],
                         ids=["1x6x5x7x10", "2x5x4x6x54"])
def test_walk_model_at_3x3x3_is_k1_plain(shape):
    """At 3×3×3 with an f32 product and an f32 add the walk gives exactly
    what ``dw_conv3d_plain(x, w, 1)`` (K1 plain's plain version) gives, and
    with fused adds what ``dw_stencil3d_plain`` gives: the order of the two
    kernels is one, so on the card K11 equals ``dw_conv_s1``."""
    x, w = _xw(shape, (3, 3, 3), seed=sum(shape))
    assert torch.equal(fwd_walk_model(x, w, fused=False)[0],
                       dw_conv3d_plain(x, w, 1))
    assert torch.equal(fwd_walk_model(x, w)[0], dw_stencil3d_plain(x, w))


@pytest.mark.parametrize("ks", [(3, 3, 3), (7, 3, 3)], ids=["3x3x3",
                                                            "7x3x3"])
def test_a_swapped_walk_is_caught(ks):
    """The same walk with the dy and dx loops swapped adds the taps in
    another order and differs from both oracles."""
    x, w = _xw((1, 6, 5, 7, 24), ks, seed=3)
    got = fwd_walk_model(x, w, swap=True)[0]
    assert not torch.equal(got, dw_stencil3d_plain(x, w))
    if ks == (3, 3, 3):
        assert not torch.equal(fwd_walk_model(x, w, fused=False,
                                              swap=True)[0],
                               dw_conv3d_plain(x, w, 1))


# ---- the plan ---------------------------------------------------------------

# (label, B, T, H = W) of the stem's conv1_t input (C = 24, 5×1×1) on every
# path, and the frames a segment the forward's plan takes there
STEM = [("serve.fine", 3, 128, 112, 64), ("serve.coarse", 3, 64, 112, 32),
        ("train.coarse", 8, 64, 112, 64), ("fine.A", 64, 16, 56, 16),
        ("fine.B", 32, 32, 72, 32), ("fine.C", 16, 32, 112, 32),
        ("fine.D", 8, 64, 112, 64)]


@pytest.mark.parametrize("label,b,t_,hw,tt", STEM, ids=[s[0] for s in STEM])
def test_fwd_plan_at_the_stem(label, b, t_, hw, tt):
    """At the stem's C = 24 a thread owns 8 channels (16 bytes of bf16) and
    a block 64 whole pixels, 3 threads each: 192 threads, six full warps.
    One block per item, at least ``FWD_BLOCKS`` of them: the whole clip a
    segment on the train paths (1,568 blocks at the coarse step), the
    serving clips split in two."""
    p = plan_stencil_fwd(b, t_, hw, hw, 24, 5, 1)
    assert (p.v, p.nvb, p.n_cg, p.pp, p.threads) == (8, 3, 1, 64, 192)
    assert p.tt == tt and p.items == b * p.n_tseg * p.npr >= FWD_BLOCKS
    assert (p.ipb, p.rows) == (1, p.items)
    if label == "train.coarse":
        assert p.items == 1568 and p.n_tseg == 1
    wg = dw_stencil.plan_stencil_wgrad(b, t_, hw, hw, 24, 5, 1)
    assert p._replace(tt=wg.tt, n_tseg=wg.n_tseg, items=wg.items,
                      ipb=wg.ipb, rows=wg.rows) == wg


def test_fwd_plan_mirror_matches_the_source():
    """``plan_stencil_fwd`` mirrors ``fwd_plan``, which sizes the
    forward's grid: the same constants and steps, on ``wg_plan``'s split;
    the kernel adds each output's taps in (dt, dy, dx) order with one
    ``fmaf`` each onto an f32 sum, reads only its own slots (no barrier, no
    atomics) and stores each finished output once."""
    assert _const("FWD_BLOCKS") == FWD_BLOCKS
    assert _const("FWD_DEPTH") == dw_stencil.FWD_DEPTH
    assert _const("WG_THREADS") == WG_THREADS
    assert _const("WG_TT_MIN") == WG_TT_MIN
    plan = " ".join(_body("inline WgPlan fwd_plan(").split())
    for step in ("WgPlan p = wg_plan(B, Tn, H, W, C, KT, KS);",
                 "while (p.TT > WG_TT_MIN && p.items < FWD_BLOCKS) {",
                 "p.TT = cdiv(p.TT, 2) > WG_TT_MIN ? cdiv(p.TT, 2) : "
                 "WG_TT_MIN;",
                 "p.n_tseg = cdiv(Tn, p.TT);",
                 "p.items = B * p.n_tseg * p.npr;",
                 "p.ipb = 1;", "p.rows = p.items;"):
        assert step in plan, step
    run = " ".join(_body("template <typename T, int KT, int KS> struct "
                         "StencilS1 {").split())
    for step in ("fwd_plan(a.B, a.Tn, a.H, a.W, a.C, KT, KS);",
                 "dim3(p.items, p.n_cg), threads, smem,",
                 "const int threads = p.PP * p.NVB;"):
        assert step in run, step
    kern = _body("stencil_fwd_kernel(const T*")
    flat = " ".join(kern.split())
    for step in ("constexpr int V = wg_vec(KT, KS), D = FWD_DEPTH;",
                 "const int pos = item % pl.npr * pl.PP + p;",
                 "const int t0 = ts * pl.TT, t1 = min(t0 + pl.TT, Tn);",
                 "copy_vec<T, V>(", "cp_wait<D - 1>();",
                 "if (ti >= 0 && ti < Tn) {",
                 "for (int j = 0; j < KT; ++j) #pragma unroll for (int s = 0;"
                 " s < NS; ++s) #pragma unroll for (int v = 0; v < V; ++v) "
                 "acc[j][v] = fmaf(wt[(KT - 1 - j) * NS + s][v], xv[s][v], "
                 "acc[j][v]);",
                 "if (to >= t0) store_vec<T, V>(yb + (size_t)to * frame, "
                 "acc[0], nc, vec);",
                 "off[dy * KS + dx] ="):
        assert step in flat, step
    for banned in ("__syncthreads", "atomic"):
        assert banned not in kern, banned


@pytest.mark.parametrize("c", [24, 13, 54, 200, 1600])
def test_fwd_plan_covers_every_channel_and_pixel_once(c):
    """The forward's blocks own each (pixel, channel) of a frame once at
    every vector width, with a channel group split where C exceeds a
    block's vectors (``n_cg``), and fit ``WG_THREADS``."""
    for kt, ks in ((5, 1), (7, 1), (3, 3), (7, 3)):
        p = plan_stencil_fwd(2, 3, 5, 7, c, kt, ks)
        assert p.threads <= WG_THREADS
        seen = torch.zeros((5 * 7, c), dtype=torch.int64)
        for pr in range(p.npr):
            for cg in range(p.n_cg):
                for tid in range(p.threads):
                    pix = pr * p.pp + tid // p.nvb
                    c0 = (cg * p.nvb + tid % p.nvb) * p.v
                    if pix < 35 and c0 < c:
                        seen[pix, c0:min(c0 + p.v, c)] += 1
        assert (seen == 1).all(), (c, kt, ks, p)


def test_column_per_thread_forward_is_gone():
    """One forward body (channel vectors), no stride template parameter,
    no stride-2 instantiation and no stride-2 entry in ``dw_stencil.cu``:
    K7 launches K4 plain's kernel."""
    assert SRC.count("stencil_fwd_kernel(const T*") == 1
    for gone in ("launch_stencil<", "int KS, int S>", "THREADS = 256",
                 'extern "C" int dw_stencil_s2(', "3, 3, 2>"):
        assert gone not in SRC, gone
    assert "dw_stencil_s2" not in dw_stencil.LIBRARY.functions
    assert "dw_stencil_s2" in dw_stencil.LAUNCHES
