"""The depthwise 3³ conv at stride (2, 2, 2) (``FineNet``'s
``t_downsample``) in the port against the JAX package's ``_lax_conv`` and
its VJP on the CPU, f32, within 1e-5 of the largest magnitude (sums in
another order): the three plain versions (``dw_conv3d_plain`` at ``T2``,
``dw_conv_dx_t2_plain``, ``dw_conv_wgrad_plain`` at ``T2``) and
``DwConv3d`` at even and odd T, H and W, and with a NaN of x on the first
frame, the last frame, the last row, the last column and inside (fault
3.4's positions): the taps' gradient has NaN exactly where JAX's has.
Also a model of the three kernels' temporal walks (``csrc/dw_plain_s2.cu``:
the forward's two-frame register ring and the dx's two dx frames a g frame
with ``ST = 2``, at every segment length; the weight gradient's g-frame
steps over a block's chained items, its ring slots and rule) against the
definition at every clip length, their work splits covering every output
once, and the wrappers' strides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.ops.pallas.dw_conv import _lax_conv
from coarse_fine_networks_torch.ops import dw_conv
from coarse_fine_networks_torch.ops.dw_conv import T2

torch.set_num_threads(2)
TOL = 1e-5
C = 6
SHAPES = [(8, 8, 8), (7, 9, 5), (4, 6, 7), (5, 3, 2), (1, 1, 1)]
NANS = {"first_frame": lambda t, h, w: (0, h // 2, w // 2),
        "last_frame": lambda t, h, w: (t - 1, h // 2, w // 2),
        "last_row": lambda t, h, w: (t // 2, h - 1, w // 2),
        "last_column": lambda t, h, w: (t // 2, h // 2, w - 1),
        "inside": lambda t, h, w: (t // 2, h // 2, w // 2)}


def _inputs(shape, seed, nan=None):
    t, h, w = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(2, t, h, w, C).astype(np.float32)
    if nan is not None:
        x[(1,) + NANS[nan](t, h, w) + (2,)] = np.nan
    k = (rng.randn(3, 3, 3, C) / 5).astype(np.float32)
    to, ho, wo = ((n - 1) // 2 + 1 for n in shape)
    g = rng.randn(2, to, ho, wo, C).astype(np.float32)
    return x, k, g


def _jax(x, k, g):
    """y, dx and the taps' gradient of JAX's ``_lax_conv`` at (2, 2, 2)."""
    y, vjp = jax.vjp(lambda a, b: _lax_conv(a, b[..., None, :], (2, 2, 2)),
                     jnp.asarray(x), jnp.asarray(k))
    dx, dk = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx), np.asarray(dk)


def _close(got, ref, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan), name
    err = np.abs(got[~nan] - ref[~nan]).max(initial=0.0)
    assert err <= TOL * max(1.0, np.abs(ref[~nan]).max(initial=0.0)), (name,
                                                                       err)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_lax_conv(shape):
    x, k, g = _inputs(shape, sum(shape))
    y, dx, dk = _jax(x, k, g)
    xt, kt, gt = map(torch.from_numpy, (x, k, g))
    _close(dw_conv.dw_conv3d_plain(xt, kt, T2), y, "y")
    _close(dw_conv.dw_conv3d(xt, kt, (2, 2, 2)), y, "y (wrapper)")
    _close(dw_conv.dw_conv_dx_t2_plain(gt, kt, shape), dx, "dx")
    _close(dw_conv.dw_conv_dx_t2(gt, kt, shape), dx, "dx (wrapper)")
    _close(dw_conv.dw_conv_wgrad_plain(xt, gt, T2).reshape(k.shape), dk,
           "dk")
    _close(dw_conv.dw_conv_wgrad(xt, gt, T2).reshape(k.shape), dk,
           "dk (wrapper)")


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_function_matches_lax_conv_vjp(shape):
    x, k, g = _inputs(shape, 2 * sum(shape))
    y, dx, dk = _jax(x, k, g)
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    yt = dw_conv.dw_conv3d_train(xt, kt, T2)
    yt.backward(torch.from_numpy(g))
    _close(yt, y, "y")
    _close(xt.grad, dx, "dx")
    _close(kt.grad, dk, "dk")


@pytest.mark.parametrize("nan", sorted(NANS))
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_nan_of_x_reaches_the_taps_it_reaches_in_jax(shape, nan):
    """Fault 3.4's positions: a NaN of x reaches exactly the taps XLA's
    weight gradient gives NaN, and y where JAX's y is NaN."""
    x, k, g = _inputs(shape, 3 * sum(shape), nan)
    y, _, dk = _jax(x, k, g)
    assert np.isnan(dk).any()
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    _close(dw_conv.dw_conv3d_plain(xt, torch.from_numpy(k), T2), y, "y")
    _close(dw_conv.dw_conv_wgrad_plain(xt, gt, T2).reshape(k.shape), dk,
           "dk")


# ---- the kernels' temporal walks (csrc/dw_plain_s2.cu, ST = 2) -----------------

def _fwd_walk(t0, t1, tn):
    """s2_fwd_body<ST = 2>: output frame -> its (dt, input frame) terms in
    the order the register ring adds them."""
    out, acc = {}, [[], []]
    f0, nf = 2 * t0 - 1, 2 * (t1 - t0 - 1) + 3
    for i in range(nf):
        ti, odd = f0 + i, i & 1
        if 0 <= ti < tn:
            for j in range(3):  # s2_frame's taps dt = 2 - j
                if (j == 1) == bool(odd):
                    acc[j >> 1].append((2 - j, ti))
        if not odd:
            to = t0 + i // 2 - 1
            if to >= t0:
                out[to] = acc[0]
            acc = [acc[1], []]
    return out


def _dx_walk(t0, t1, tn, tg):
    """dx_s2_body<ST = 2>: dx frame -> its (dt, g frame) terms in order."""
    out = {}
    for o in range(t0, t1):
        for e in range(2):
            if 2 * o + e >= tn:
                break
            out[2 * o + e] = [(1 if e == 0 else 2 - 2 * f, o + f)
                              for f in range(2)
                              if not (e == 0 and f == 1)
                              and not (f == 1 and o + 1 >= tg)]
    return out


def _wgrad_walk(tn, items):
    """plain_t2_wgrad_kernel: a block's walk over ``items`` clips of ``tn``
    frames (one item each, g frames 0 .. to-1), as one stream of steps.  Step
    s loads step s+1's x frames 2o and 2o+1 into ring slots 2s+2 and 2s+3
    and its g frame into slot s+1 while it reads x frames 2o-1, 2o, 2o+1
    (taps dt = 0, 1, 2; slots 2s-1, 2s, 2s+1) and g frame o (slot s), so a
    read of a slot overwritten by that load would be a hazard: each read is
    checked against the frame it must find.  Returns each item's (x frame,
    dt, g frame) products in the order they are added."""
    to = (tn - 1) // 2 + 1
    xs, gs = dw_conv.T2_XSLOTS, dw_conv.T2_GSLOTS
    steps = items * to
    xslot, gslot = {}, {}
    pairs = [[] for _ in range(items)]

    def load(s):
        if s < steps:
            it, o = divmod(s, to)
            for e in range(2):
                if 2 * o + e < tn:
                    xslot[(2 * s + e) % xs] = (it, 2 * o + e)
            gslot[s % gs] = (it, o)

    load(0)
    for s in range(steps):
        load(s + 1)  # after the barrier, beside this step's reads
        it, o = divmod(s, to)
        assert gslot[s % gs] == (it, o)
        for dt, slot in ((0, (2 * s + xs - 1) % xs), (1, 2 * s % xs),
                         (2, (2 * s + 1) % xs)):
            # x frame 2o-1 where o > 0, 2o+1 inside the clip
            if (dt == 0 and o == 0) or (dt == 2 and 2 * o + 1 >= tn):
                continue
            assert xslot[slot] == (it, 2 * o + dt - 1), (s, dt)
            pairs[it].append((2 * o + dt - 1, dt, o))
    return pairs


@pytest.mark.parametrize("tn", range(1, 20))
def test_kernel_walks_match_the_definition(tn):
    to = (tn - 1) // 2 + 1
    for tt in range(1, to + 1):
        segs = [(s, min(s + tt, to)) for s in range(0, to, tt)]
        fwd, dx = {}, {}
        for s in segs:
            fwd.update(_fwd_walk(*s, tn))
            dx.update(_dx_walk(*s, tn, to))
        # every output frame once, its taps in order dt = 0, 1, 2
        assert fwd == {o: [(dt, 2 * o + dt - 1) for dt in range(3)
                           if 0 <= 2 * o + dt - 1 < tn] for o in range(to)}
        # every dx frame once, its g frames ascending (K8's order)
        assert dx == {f: sorted([(dt, o) for o in range(to) for dt in range(3)
                                 if 2 * o + dt - 1 == f], key=lambda p: p[1])
                      for f in range(tn)}
    # the weight gradient has one segment a clip; a block chains 1-4 items
    for items in range(1, 5):
        for pairs in _wgrad_walk(tn, items):
            # every (x frame, tap, g frame) product once and no other: a NaN
            # of x reaches the taps it reaches in the plain version
            assert sorted(pairs) == sorted(
                (2 * o + dt - 1, dt, o) for o in range(to) for dt in range(3)
                if 0 <= 2 * o + dt - 1 < tn)
            # each tap's products x frames ascending (K10 plain's order)
            for dt in range(3):
                ti = [p[0] for p in pairs if p[1] == dt]
                assert ti == sorted(ti)


def _whole_pixel_reads(w, c, esz, wb, r, h, h0, w0, seed):
    """plain_t2_wgrad_kernel's whole-pixel mode on one x frame: the chunks
    t2_stage_whole copies (16-byte aligned, those holding a byte of a pixel
    of the tile inside the frame; rows outside the frame zero) into a slot
    of stale bytes, then each thread's reads at at[dx] (the pixel 2wl-1+dx
    of the tile at a byte stride of C * esz from d) under its mask ok.
    Returns (got, want): per (thread, staged row, dx) the pair read and the
    frame's pair there (zero outside the frame)."""
    rng = np.random.RandomState(seed)
    pb, rowb = c * esz, 16 * ((2 * wb + 1) * c * esz // 16 + 2)
    dt = {2: np.uint16, 4: np.uint32}[esz]
    guard = 64  # bytes of other memory around the frame (16-byte aligned)
    mem = rng.randint(0, 256, guard + h * w * pb + guard).astype(np.uint8)
    frame = mem[guard:guard + h * w * pb].view(dt).reshape(h, w, c)
    p0, npx, hs, nrows = 2 * w0 - 1, 2 * wb + 1, 2 * h0 - 1, 2 * r + 1
    slot = np.full((nrows, rowb), 0xAB, np.uint8)
    for rr in range(nrows):
        hh = hs + rr
        if not 0 <= hh < h:
            slot[rr] = 0
            continue
        row = guard + hh * w * pb
        base = (row + p0 * pb) // 16 * 16
        for k in range(rowb // 16):
            a = base + 16 * k
            if a + 16 > row + max(p0, 0) * pb and a < row + min(p0 + npx,
                                                                w) * pb:
                slot[rr, 16 * k:16 * k + 16] = mem[a:a + 16]
    d = (p0 * pb) % 16
    got, want = [], []
    for wl in range(wb):
        for pi in range(c // 2):
            at0 = (d + 2 * wl * pb) // esz + 2 * pi
            for rr in range(nrows):
                vals = slot[rr].view(dt)
                for dx in range(3):
                    px, hh = p0 + 2 * wl + dx, hs + rr
                    ok = 0 <= px < w
                    e = at0 + dx * c
                    got.append(tuple(vals[e:e + 2]) if ok else (0, 0))
                    want.append(tuple(frame[hh, px, 2 * pi:2 * pi + 2])
                                if ok and 0 <= hh < h else (0, 0))
    return got, want


@pytest.mark.parametrize("w, c, esz", [(8, 2, 2), (16, 6, 2), (8, 54, 2),
                                       (4, 6, 4), (13, 8, 4), (12, 54, 4)])
def test_whole_pixel_staging_reads_the_tile(w, c, esz):
    """The weight gradient's whole-pixel mode (a block's channel group is
    the pixel, rows 16-byte aligned): at every column tile and row strip,
    each thread's taps read the frame's pair at its pixel, zero on rows
    outside the frame and masked columns, never a stale or neighbouring
    byte."""
    assert w * c * esz % 16 == 0
    h = 5
    for wb in (2, 3):
        wo = (w - 1) // 2 + 1
        for w0 in range(0, wo, wb):
            for r, h0 in ((2, 0), (2, 2), (3, 3)):
                got, want = _whole_pixel_reads(w, c, esz, wb, r, h, h0, w0,
                                               w0 + r)
                assert got == want, (wb, w0, r, h0)


def test_the_source_has_the_walks():
    src = (dw_conv.LIBRARY_S2.source).read_text()
    for name in ("plain_t2_fwd_kernel", "plain_t2_dx_kernel",
                 "plain_t2_wgrad_kernel", 'extern "C" int dw_conv_t2(',
                 'extern "C" int dw_conv_dx_t2(',
                 'extern "C" int dw_conv_wgrad_t2('):
        assert name in src, name
    # the weight gradient's ring and rule (_wgrad_walk)
    for text in ("constexpr int T2_XSLOTS = 5;", "constexpr int T2_GSLOTS = 2;",
                 "cp_wait<0>();\n    __syncthreads();\n    load(s + 1);",
                 "T* slot = xring + (2 * s + e) % T2_XSLOTS * xstage;",
                 "sg.g_rows(gring + s % T2_GSLOTS * gstage,",
                 "(2 * s + T2_XSLOTS - 1) % T2_XSLOTS * xstage;",
                 "const T* xb = xring + 2 * s % T2_XSLOTS * xstage;",
                 "const T* xc = xring + (2 * s + 1) % T2_XSLOTS * xstage;",
                 "const bool a = o > 0, c = 2 * o + 1 < Tn;",
                 "if (wl < WB && tl.w0 + wl < Wo) {",
                 "dy > 2 || (!FULL && r >= nr)) continue;",
                 "TT < To || ipb < 1)"):
        assert text in src, text
    assert "wgrad_slots_t2" not in src
    assert (dw_conv.T2_XSLOTS, dw_conv.T2_GSLOTS) == (5, 2)
    assert "constexpr int GSTAGE_T2 = 4;" in src
    assert dw_conv.GSTAGE_T2 == 4


# ---- the work splits and the wrappers -------------------------------------------

# the four t_downsample entries of FineNet at B32 T16 224² and B64 T16 112²,
# and ragged ones
PLAN_SHAPES = [(32, 16, 112, 112, 54), (32, 8, 56, 56, 108),
               (32, 4, 28, 28, 216), (32, 2, 14, 14, 432),
               (64, 16, 56, 56, 54), (64, 8, 28, 28, 108),
               (64, 4, 14, 14, 216), (64, 2, 7, 7, 432),
               (3, 9, 13, 11, 30), (2, 5, 9, 7, 7), (1, 1, 3, 3, 2)]


def _covers(p, t, h, w, c):
    """Every (sample, frame, row, column, channel) of ``(B, t, h, w, c)``
    in exactly one tile of plan ``p``."""
    seen = np.zeros((p.b, t, h, w, c), np.int32)
    for item in range(p.items):
        for pg in range(p.n_pg):
            b, (t0, t1), (h0, h1), (w0, w1), (c0, c1) = p.tile(item, pg)
            seen[b, t0:t1, h0:h1, w0:w1, c0:c1] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plans_cover_the_output(shape):
    b, t, h, w, c = shape
    to, ho, wo = (t - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1
    for plan in (dw_conv.plan_t2_fwd, dw_conv.plan_t2_dx, dw_conv.plan_t2):
        p = plan(*shape)
        assert (p.t, p.h, p.w, p.c) == (to, ho, wo, c)
        assert p.wb * p.pg <= dw_conv.NT_MAX
        assert _covers(p, to, ho, wo, c), plan.__name__
    assert dw_conv.smem_s2_fwd(dw_conv.plan_t2_fwd(*shape),
                               4) <= dw_conv.SMEM_MAX
    assert dw_conv.smem_t2_dx(dw_conv.plan_t2_dx(*shape), 4) <= dw_conv.SMEM_MAX
    p = dw_conv.plan_t2(*shape)
    assert dw_conv.smem_t2(p, 4) <= dw_conv.SMEM_MAX
    # one segment a clip, channel pairs first: a pixel of at most
    # T2_WHOLE_PG pairs in one group (where its shared memory fits), wider
    # ones in groups of at most DX_PG
    assert p.tt == to and p.n_tseg == 1
    p2 = (c + 1) // 2
    if p2 <= dw_conv.T2_WHOLE_PG:
        assert p.pg == p2 or dw_conv.smem_t2(p._replace(pg=p2), 4) > (
            dw_conv.SMEM_MAX)
    else:
        assert p.pg <= dw_conv.DX_PG
    # the persistent grid: every block has an item, the blocks cover all
    assert p.rows * p.ipb >= p.items > (p.rows - 1) * p.ipb
    # K10 plain launched with this split and one segment of t frames (g at
    # the even frames of a zero tensor) has the same items and blocks, and
    # fits
    q = p._replace(t=t, tt=t)
    assert (q.items, q.n_pg) == (p.items, p.n_pg)
    assert dw_conv.smem_s2(p, 4) <= dw_conv.SMEM_MAX


def test_wrappers_take_t2_and_refuse_other_strides():
    x = torch.zeros(1, 4, 5, 5, 6)
    k = torch.zeros(3, 3, 3, 6)
    assert dw_conv.dw_conv3d(x, k, T2).shape == (1, 2, 3, 3, 6)
    assert dw_conv.dw_conv3d(x, k, (1, 2, 2)).shape == (1, 4, 3, 3, 6)
    for stride in ((2, 1, 1), (2, 2, 1), 3, (1, 3, 3)):
        with pytest.raises(ValueError):
            dw_conv.dw_conv3d(x, k, stride)
    with pytest.raises(ValueError):  # g of another stride
        dw_conv.dw_conv_dx_t2(torch.zeros(1, 4, 3, 3, 6), k, (4, 5, 5))
    with pytest.raises(ValueError):
        dw_conv.dw_conv_wgrad(x, torch.zeros(1, 4, 3, 3, 6), T2)
    assert set(dw_conv.LAUNCHES) >= {"dw_conv_t2", "dw_conv_dx_t2",
                                     "dw_conv_wgrad_t2"}
