"""The row-strip weight gradients at the clip's and the frame's edges (fault
3.4), and the plans of K4 act and K6 mm.

The row-strip weight gradients (K6 and K10, plain, act and mm:
``csrc/dw_plain_s1.cu``, ``csrc/dw_plain_s2.cu``) walk work items (sample,
frame segment, row strip, column tile); while an item's x frame is read, a
register ring of three slots holds the g frames it meets, and a slot whose
g frame lies outside the item's segment, or a row or column past the
output, holds a zero.  The kernels add a product only where the ring holds
a g element of the item (``wgrad_slots`` and the strip's rows and the
thread's column, ``csrc/strip.cuh``): x·0 would carry a NaN of x into a
tap no output position reaches.  The kernels run only on the card, where
``chip_smoke.py``'s ``edges`` phase holds them against their twins with
x's NaN on those edges.  Here, on the CPU:

* a torch model of the walk (:func:`walk_model`: the plan's items, the
  ring's slots and zeros, the rule) puts NaN where the twin does
  (``wgrad_f32``, which sums only the output's positions) at every edge,
  with ragged strips, frame segments and ragged column tiles; without the
  rule it shows fault 3.4's extra NaN taps; on finite x both equal the
  twin (the rule moves no finite sum);
* the sources apply the rule in every weight-gradient body;
* the plan of K4 act (``plan_act_s2_fwd``) and of K6 mm
  (``plan_mm_wgrad_s1``) fit the card at the path's shapes, in bf16 and
  f32, and cover every output once; K4 plain's plan is unchanged;
* ``dw_mm_act.cu`` has no act mode, and no source keeps a weight gradient
  off the row strips (``dw_act_bwd.cu`` is gone).
"""

import numpy as np
import pytest
import torch

from coarse_fine_networks_torch.ops import dw_conv, dw_mm_act
from coarse_fine_networks_torch.ops.dw_conv import (
    NT_DX, NT_MAX, SMEM_MAX, plan_act_s2_fwd, plan_mm_wgrad_s1, plan_s1,
    plan_s2, plan_s2_fwd, smem_mm_wgrad_s1, smem_s2_fwd)
from coarse_fine_networks_torch.ops.dw_mm_act import wgrad_f32

torch.set_num_threads(2)


def walk_model(x, g, stride, plan, rule=True):
    """``dk (27, C)`` as the row-strip weight gradients sum it, in f32: for
    each of ``plan``'s items and each of its x frames i (frame t0 - 1 + i,
    in the clip), ring slot j holds g frame t0 - 2 + i + j at the item's
    output rows h0 + r, r < R, and columns w0 + wl, wl < WB, or zero where
    that frame lies outside the item's segment or the position past the
    output; each slot meets x frame t0 - 1 + i through tap dt = 2 - j, row
    s·(h0 + r) - 1 + dy, column s·(w0 + wl) - 1 + dx (zero outside the
    frame).  With ``rule`` a product is added only where the slot holds a g
    element of the item, as the kernels do; without, wherever the ring's
    zero stands."""
    b_, t_, h_, w_, c = x.shape
    ho, wo = g.shape[2:4]
    r_, wb = plan.r, plan.wb
    s = stride
    # x zero-padded by one before each axis and far enough after it that
    # every tile's reads, past the frame too, land on a zero
    xp = torch.zeros((b_, t_ + 2, s * (ho + r_) + 3, s * (wo + wb) + 3, c))
    xp[:, 1:t_ + 1, 1:h_ + 1, 1:w_ + 1] = x.float()
    gp = torch.zeros((b_, t_, ho + r_, wo + wb, c))
    gp[:, :, :ho, :wo] = g.float()
    dk = torch.zeros((27, c))
    for item in range(plan.items):
        b, (t0, t1), (h0, _), (w0, _), _ = plan.tile(item, 0)
        nf = t1 - t0 + 2
        cols = slice(w0, w0 + wb)
        wl_ok = torch.arange(w0, w0 + wb) < wo  # the thread's column exists
        for i in range(nf):
            ti = t0 - 1 + i
            if not 0 <= ti < t_:  # frames outside the clip add nothing
                continue
            for j in range(3):
                tg = ti - 1 + j
                held = t0 <= tg < t1  # the slot holds the item's g frame
                if rule and not held:
                    continue
                for r in range(r_):
                    if rule and h0 + r >= ho:
                        continue
                    gv = (gp[b, tg, h0 + r, cols] if held else
                          torch.zeros((wb, c)))
                    if rule:
                        gv = gv[wl_ok]
                    for dy in range(3):
                        for dx in range(3):
                            xs = xp[b, ti + 1, s * (h0 + r) + dy,
                                    s * w0 + dx:s * (w0 + wb - 1) + dx + 1:s]
                            if rule:
                                xs = xs[wl_ok]
                            dk[((2 - j) * 3 + dy) * 3 + dx] += torch.sum(
                                xs * gv, dim=0)
    return dk


# (shape of x, stride, (tt, wb) overrides of the plan: frame segments and
# ragged column tiles); every strip set is ragged (H or Ho = 7 at R = 4)
CASES = [((2, 7, 7, 9, 4), 1, None), ((2, 7, 7, 9, 4), 1, (3, 4)),
         ((2, 7, 14, 14, 4), 2, None), ((2, 7, 14, 14, 4), 2, (3, 3))]
CIDS = [f"s{s}-{'x'.join(map(str, sh))}-{'plan' if o is None else 'split'}"
        for sh, s, o in CASES]
# (t, h, w) of x's NaN, at channel 0 of sample 1, from (T, H, W)
EDGES = {"first_frame": lambda t, h, w: (0, 3, 4),
         "last_frame": lambda t, h, w: (t - 1, 3, 4),
         "last_row": lambda t, h, w: (3, h - 1, 4),
         "last_column": lambda t, h, w: (3, 3, w - 1)}


def _case(shape, stride, over, seed):
    rng = np.random.RandomState(seed)
    b, t, h, w, c = shape
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, t, (h - 1) // stride + 1,
                                   (w - 1) // stride + 1, c).astype(
                                       np.float32))
    plan = (plan_s1 if stride == 1 else plan_s2)(*shape)
    if over is not None:
        plan = plan._replace(tt=over[0], wb=over[1])
    assert plan.h == g.shape[2] and plan.h % plan.r  # a ragged strip
    return x, g, plan


@pytest.mark.parametrize("case", CASES, ids=CIDS)
def test_walk_model_sums_the_twin_on_finite_x(case):
    """On finite x the walk is the twin's sum with the rule and without:
    skipping a product whose g is the ring's zero moves no sum."""
    x, g, plan = _case(*case, seed=1)
    want = wgrad_f32(x, g, case[1])
    for rule in (True, False):
        torch.testing.assert_close(walk_model(x, g, case[1], plan, rule),
                                   want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("where", list(EDGES))
@pytest.mark.parametrize("case", CASES, ids=CIDS)
def test_walk_model_puts_nan_where_the_twin_does(case, where):
    """x's NaN on an edge: with the rule the walk's NaN taps are the twin's
    (whose finite taps it matches), without the rule it has more (fault
    3.4: the clip's first and last frames, a ragged strip's last row, a
    ragged column tile's last column), except where no ring slot holds a
    zero that meets the NaN (an edge column with no column tile past it)."""
    x, g, plan = _case(*case, seed=2)
    shape, stride, _ = case
    x[(1,) + EDGES[where](*shape[1:4]) + (0,)] = float("nan")
    want = wgrad_f32(x, g, stride)
    got = walk_model(x, g, stride, plan)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(want[:, 0]).any() and not torch.isnan(want[:, 1:]).any()
    fin = ~torch.isnan(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-4)
    fault = walk_model(x, g, stride, plan, rule=False)
    extra = torch.isnan(fault) & ~torch.isnan(want)
    assert torch.isnan(fault[torch.isnan(want)]).all()
    ragged_cols = plan.n_wt * plan.wb > plan.w
    if where != "last_column" or ragged_cols:
        assert extra.any(), "the walk without the rule shows no fault"
    else:
        assert not extra.any()


def test_the_sources_apply_the_rule_in_every_weight_gradient():
    """K6 and K10 (plain, act, mm) admit a ring slot only by
    ``wgrad_slots``, a row only below the output's last and a column only
    inside it, through the masked stencils of ``strip.cuh`` and
    ``dw_plain_s2.cu``; the masked variants run slot by slot.  The
    stride-(2, 2, 2) weight gradient's body applies the same row bound
    (its slots and columns: ``tests/test_torch_port_t2.py``)."""
    csrc = dw_conv.LIBRARY.source.parent
    strip = (csrc / "strip.cuh").read_text()
    s1 = dw_conv.LIBRARY.source.read_text()
    s2 = dw_conv.LIBRARY_S2.source.read_text()
    body = strip[strip.index("unsigned wgrad_slots("):]
    assert "i + j >= 2 && i + j <= nf - 1" in body[:body.index("\n}\n")]
    assert "void stencil_frame_masked(" in strip
    assert "void s2_frame_masked(" in s2
    for src, rows, cols, n_rows in (
            (s1, "nr = min(R, H - tl.h0);", "live = in && tl.w0 + wl < W;", 2),
            (s2, "nr = min(R, Ho - tl.h0);", "live = in && tl.w0 + wl < Wo;",
             3)):
        assert src.count(rows) == n_rows and src.count(cols) == 2
    assert s1.count("wgrad_slots(") == 2 and s2.count("wgrad_slots(") == 2
    assert "stencil_frame_masked<T, R, ROWS_ONCE>(" in s1
    assert "s2_frame_masked<T, R, !ACT>(" in s2
    assert "s2_frame_masked<T, R, true>(" in s2  # K10 mm


def test_entry_sources_keep_no_act_mode_and_no_stride1_wgrad():
    """``dw_mm_act.cu`` holds the stride-1 mm forward only (K1 mm; K4 mm
    is ``dw_plain_s2.cu``'s): no act mode, no ``Mode``; the entry
    backward's tile source (``dw_act_bwd.cu``, K10 mm's last home) is gone:
    K6 mm is ``dw_plain_s1.cu``'s, K9 and K10 mm ``dw_plain_s2.cu``'s, and
    the entry's module binds no source of its own beyond K1 mm's and the
    stride-1 dx's."""
    fwd = dw_mm_act.LIBRARY.source.read_text()
    code = "\n".join(line.split("//")[0] for line in fwd.splitlines())
    for gone in ("ACT", "Mode", "MODE", "dw_act_s2", "act<T>"):
        assert gone not in code
    assert set(dw_mm_act.LIBRARY.functions) == {
        "dw_mm_act_s1", "dw_mm_act_s1_occupancy"}
    assert not (dw_mm_act.SOURCE.parent / "dw_act_bwd.cu").exists()
    assert dw_mm_act.LIBRARIES == (dw_mm_act.LIBRARY,
                                   dw_mm_act.DX_S1_LIBRARY)
    assert "dw_mm_wgrad_s1" in dw_conv.LIBRARY.functions
    assert "dw_act_s2" in dw_conv.LIBRARY_S2.functions
    assert {"dw_mm_act_s2", "dw_mm_dx_mask_s2", "dw_mm_wgrad_s2"} <= set(
        dw_conv.LIBRARY_S2.functions)


# ---- the plans ---------------------------------------------------------------

# x of K4 act at the path's entries: (B, T, H, C) of the coarse train step
# and of long-cycle phase D
PATH_S2 = [(8, 64, 112, 54), (8, 17, 56, 108), (8, 17, 28, 216),
           (8, 17, 14, 432), (8, 64, 56, 108), (8, 64, 28, 216),
           (8, 64, 14, 432)]
# x (B, T, H, C_in) and C_mid of K6 mm at the path's entries (train_mm's
# coarse step, long-cycle phase D)
PATH_MM = [((8, 64, 56, 24), 54), ((8, 17, 28, 48), 108),
           ((8, 17, 14, 96), 216), ((8, 17, 7, 192), 432),
           ((8, 64, 28, 48), 108), ((8, 64, 14, 96), 216),
           ((8, 64, 7, 192), 432)]
# K4 plain's plans (R, WB, PG, TT) at the split route's stride-2 entries of
# long-cycle phases A-C and at the act route's, as they were before K4 act
# had a plan of its own
K4_PLAIN = [
    ((64, 16, 56, 56, 54), (4, 28, 9, 16)),
    ((64, 16, 28, 28, 108), (4, 14, 18, 16)),
    ((64, 16, 14, 14, 216), (4, 7, 36, 8)),
    ((64, 16, 7, 7, 432), (4, 4, 54, 8)),
    ((32, 32, 72, 72, 54), (4, 36, 7, 32)),
    ((32, 32, 36, 36, 108), (4, 18, 14, 32)),
    ((32, 32, 18, 18, 216), (3, 9, 27, 16)),
    ((32, 32, 9, 9, 432), (3, 5, 44, 16)),
    ((16, 32, 112, 112, 54), (4, 56, 4, 32)),
    ((16, 32, 56, 56, 108), (4, 28, 9, 32)),
    ((16, 32, 28, 28, 216), (4, 14, 18, 16)),
    ((16, 32, 14, 14, 432), (4, 7, 36, 8)),
    ((8, 64, 112, 112, 54), (4, 56, 4, 64)),
    ((8, 17, 56, 56, 108), (4, 28, 9, 9)),
    ((8, 17, 28, 28, 216), (4, 14, 18, 8)),
    ((8, 17, 14, 14, 432), (4, 7, 36, 8)),
    ((8, 64, 56, 56, 108), (4, 28, 9, 32)),
    ((8, 64, 28, 28, 216), (4, 14, 18, 16)),
    ((8, 64, 14, 14, 432), (4, 7, 36, 8))]


def _covers_once(p, shape):
    """Every output position and channel of ``shape`` (B, T, h, w, C: the
    plan's tiled positions) belongs to one (item, channel group)."""
    b, t, h, w, c = shape
    count = np.zeros((b, t, h, w, 2 * p.n_pg * p.pg), np.uint8)
    for item in range(p.items):
        for g in range(p.n_pg):
            bi, (t0, t1), (h0, h1), (w0, w1), (c0, c1) = p.tile(item, g)
            count[bi, t0:t1, h0:h1, w0:w1, c0:c1] += 1
    assert (count[..., :c] == 1).all() and not count[..., c:].any()


@pytest.mark.parametrize("shape,want", K4_PLAIN,
                         ids=["x".join(map(str, s)) for s, _ in K4_PLAIN])
def test_k4_plain_plan_is_unchanged(shape, want):
    """K4 act has a plan of its own (its ring is a frame deeper); K4
    plain's split stays what it was at every shape of the path."""
    p = plan_s2_fwd(*shape)
    assert (p.r, p.wb, p.pg, p.tt) == want


@pytest.mark.parametrize("esz", [2, 4])
def test_act_s2_fwd_plan_fits_and_covers(esz):
    """K4 act's plan at the path's shapes: its ring of ``NSTAGE_ACT``
    frames within a block's shared memory and, in bf16, two blocks per SM
    (228 KB); at most ``NT_MAX`` threads; every output once; the ring one
    frame deeper than K4 plain's with the same split (the f32 act ring fits
    without cutting the pairs at these shapes)."""
    for b, t, h, c in PATH_S2:
        p = plan_act_s2_fwd(b, t, h, h, c)
        act = smem_s2_fwd(p, esz, True)
        assert act <= SMEM_MAX and (esz == 4 or 2 * act <= 228 * 1024)
        assert act == 4 * smem_s2_fwd(p, esz) // 3
        assert p.threads <= NT_MAX and p == plan_s2_fwd(b, t, h, h, c)
        if t == 17:
            _covers_once(p, (b, t, p.h, p.w, c))


@pytest.mark.parametrize("esz", [2, 4])
def test_mm_wgrad_plan_fits_and_covers(esz):
    """K6 mm's plan at the path's shapes: within a block's shared memory
    and, in bf16, two blocks per SM; at most ``NT_DX`` threads (its
    registers); a persistent grid whose rows of ``ipb`` items each cover the
    items once; every output once; and K6 plain takes the same plan (the
    chip's exact oracle launches it with K6 mm's)."""
    for (b, t, h, c_in), c in PATH_MM:
        p = plan_mm_wgrad_s1(b, t, h, h, c_in, c, esz)
        sm = smem_mm_wgrad_s1(p, c_in, esz)
        assert sm <= SMEM_MAX and (esz == 4 or 2 * sm <= 228 * 1024)
        assert p.wb * p.pg <= NT_DX and p.threads <= NT_DX
        assert p.rows * p.ipb >= p.items > (p.rows - 1) * p.ipb
        assert p.rows * p.n_pg <= 2 * dw_conv.SMS
        assert p.smem(esz, True) <= SMEM_MAX  # K6 plain's ring at the plan
        assert (p.r, p.wb) == (plan_s1(b, t, h, h, c).r,
                               plan_s1(b, t, h, h, c).wb)
        if t == 17:
            _covers_once(p, (b, t, h, h, c))


def test_mm_wgrad_plan_cuts_pairs_for_shared_memory():
    """Where W1's columns are deep, the pairs are cut into more groups
    until a block fits the card."""
    p = plan_mm_wgrad_s1(1, 4, 9, 9, 320, 96, 4)
    assert p.pg < dw_conv._strips(1, 4, 9, 9, 96, nt=NT_DX).pg
    assert smem_mm_wgrad_s1(p, 320, 4) <= SMEM_MAX
    assert smem_mm_wgrad_s1(p._replace(pg=-(-48 // (p.n_pg - 1))), 320,
                            4) > SMEM_MAX


def test_pair_cuts_end():
    """Cutting the pairs into more groups never stalls where one more group
    keeps the groups' width (48 pairs: 8 groups of 6, then 9 groups of 6):
    the groups then narrow by a pair, down to one pair."""
    p = dw_conv.PlanS1(1, 1, 1, 1, 96, 2, 1, 6, 1, 1, 1)
    assert p.n_pg == 8 and dw_conv._narrower(p).pg == 5
    seen = [p.pg]
    while p.pg > 1:
        p = dw_conv._narrower(p)
        seen.append(p.pg)
    assert seen == sorted(seen, reverse=True) and len(set(seen)) == len(seen)
