"""The depthwise 3³ conv at stride (2, 2, 2) (``FineNet``'s
``t_downsample``) in the port against the JAX package's ``_lax_conv`` and
its VJP on the CPU, f32, within 1e-5 of the largest magnitude (sums in
another order): the three plain versions (``dw_conv3d_plain`` at ``T2``,
``dw_conv_dx_t2_plain``, ``dw_conv_wgrad_plain`` at ``T2``) and
``DwConv3d`` at even and odd T, H and W, and with a NaN of x on the first
frame, the last frame, the last row, the last column and inside (fault
3.4's positions): the taps' gradient has NaN exactly where JAX's has.
Also a model of the three kernels' temporal walks (``csrc/dw_plain_s2.cu``:
the forward's steps of two input frames into two output frames in
registers, its ring slots and mbarrier phases; the dx's two dx frames a g
frame with its g ring and double-buffered dx tiles, at every segment
length; the weight gradient's g-frame steps over a block's chained items,
its ring slots and rule) against the definition at every clip length, the
whole-pixel staging (the weight gradient's 16-byte chunks, the forward's
bulk copies) against the frame, the dx tile's write-out by bulk copies
against dx, their work splits covering every output once, the wrappers'
choice of mode, and the wrappers' strides."""

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

def _fwd_walk(t0, t1, tn, ahead=None):
    """plain_t2_fwd_kernel's walk over the output frames [t0, t1): output
    frame -> its (dt, input frame) terms in the order they are added.  Frame
    index i (input frame 2t0-1+i) goes to ring slot i % T2F_SLOTS; the
    segment's frame 2t0-1 is read alone first, then step s waits for i =
    2s+1 (and, after reading it, 2s+2), stages step s + ``ahead``'s frames
    beside its reads (so
    a read of a slot that load overwrote would be a hazard: each read is
    checked against the frame it must find) and adds frame 2(t0+s) to
    output t0+s (dt = 1) and frame 2(t0+s)+1 to it (dt = 2) and to the next
    (dt = 0).  Each slot's mbarrier has one arrival a use; a wait for use u
    passes on parity u & 1, so it must find exactly u + 1 arrivals (u + 2
    would alias)."""
    ahead = dw_conv.T2F_AHEAD if ahead is None else ahead
    ns = 2 * (ahead + 1)
    f0, nf = 2 * t0 - 1, 2 * (t1 - t0) + 1
    slot, arrivals = {}, [0] * ns

    def stage(i):
        if i < nf:
            slot[i % ns] = i
            arrivals[i % ns] += 1

    def load(s):
        if s == 0:
            stage(0)
        stage(2 * s + 1)
        stage(2 * s + 2)

    def wait(i):
        if i < nf:
            assert arrivals[i % ns] == i // ns + 1, (i, arrivals)

    def read(i):
        assert slot[i % ns] == i, (i, slot)
        return f0 + i

    out, acc = {}, [[], []]
    for s in range(ahead):
        load(s)
    if f0 >= 0:
        wait(0)
        acc[0].append((0, read(0)))
    for s in range(t1 - t0):
        wait(2 * s + 1)
        load(s + ahead)
        acc[0].append((1, read(2 * s + 1)))
        wait(2 * s + 2)
        if f0 + 2 * s + 2 < tn:
            ti = read(2 * s + 2)
            acc[0].append((2, ti))
            acc[1].append((0, ti))
        out[t0 + s] = acc[0]
        acc = [acc[1], []]
    return out


def _dx_walk(t0, t1, tn, tg):
    """plain_t2_dx_kernel's walk over the g frames [t0, t1): dx frame -> its
    (dt, g frame) terms in order.  Each read of the g ring (GSTAGE_T2 slots,
    g frame t0+i in slot i % GSTAGE_T2; step i's load beside its reads after
    its first barrier) is checked against the frame it must find, and each
    dx frame's sums are put into tile ox & 1 only where no write-out begun
    since the last barrier still reads that tile."""
    gs = dw_conv.GSTAGE_T2
    nf = t1 - t0 + 1
    ring, pending, out = {}, set(), {}

    def load(i):
        if i < nf and t0 + i < tg:
            ring[i % gs] = t0 + i

    def read(i):
        assert ring[i % gs] == t0 + i, (i, ring)
        return t0 + i

    def put(ox, terms):
        assert ox & 1 not in pending, (ox, pending)
        out[ox] = terms

    for i in range(gs - 1):
        load(i)
    for o in range(t0, t1):
        i = o - t0
        put(2 * o, [(1, read(i))])
        pending.clear()  # the first barrier
        load(i + gs - 1)
        pending.add(2 * o & 1)  # dx frame 2o's write-out
        if 2 * o + 1 < tn:
            terms = [(2, read(i))]
            if o + 1 < tg:
                terms.append((0, read(i + 1)))
            put(2 * o + 1, terms)
            pending.clear()  # the second barrier
            pending.add(1)
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
    # a ring two steps deep (chip_rule2.py's variant) walks the same
    for tt in range(1, to + 1):
        fwd = {}
        for s in range(0, to, tt):
            fwd.update(_fwd_walk(s, min(s + tt, to), tn, ahead=2))
        assert fwd == {o: [(dt, 2 * o + dt - 1) for dt in range(3)
                           if 0 <= 2 * o + dt - 1 < tn] for o in range(to)}
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


def _bulk_reads(w, c, esz, wb, r, h, h0, w0, seed):
    """plain_t2_fwd_kernel's bulk mode on one x frame: t2_bulk_whole's one
    copy a row inside the frame (the 16-byte span holding the tile's pixels
    inside [0, w), placed as t2_stage_whole places its chunks) into a slot
    of stale bytes, rows outside the frame not copied; then each thread's
    reads at at[dx] under its masks (rows and ok).  Returns (got, want) as
    _whole_pixel_reads does."""
    rng = np.random.RandomState(seed)
    pb, rowb = c * esz, 16 * ((2 * wb + 1) * c * esz // 16 + 2)
    dt = {2: np.uint16, 4: np.uint32}[esz]
    guard = 64
    mem = rng.randint(0, 256, guard + h * w * pb + guard).astype(np.uint8)
    frame = mem[guard:guard + h * w * pb].view(dt).reshape(h, w, c)
    p0, npx, hs, nrows = 2 * w0 - 1, 2 * wb + 1, 2 * h0 - 1, 2 * r + 1
    base = (p0 * pb) // 16 * 16
    lo = max(p0, 0) * pb // 16 * 16
    hi = -(-min(p0 + npx, w) * pb // 16) * 16
    assert hi <= w * pb and hi - lo <= rowb - (lo - base)
    slot = np.full((nrows, rowb), 0xAB, np.uint8)
    for rr in range(nrows):
        if 0 <= hs + rr < h:
            row = guard + (hs + rr) * w * pb
            slot[rr, lo - base:hi - base] = mem[row + lo:row + hi]
    d = (p0 * pb) % 16
    got, want = [], []
    for wl in range(wb):
        for pi in range(c // 2):
            at0 = (d + 2 * wl * pb) // esz + 2 * pi
            for rr in range(nrows):
                vals = slot[rr].view(dt)
                for dx in range(3):
                    px, hh = p0 + 2 * wl + dx, hs + rr
                    ok = 0 <= px < w and 0 <= hh < h
                    e = at0 + dx * c
                    got.append(tuple(vals[e:e + 2]) if ok else (0, 0))
                    want.append(tuple(frame[hh, px, 2 * pi:2 * pi + 2])
                                if ok else (0, 0))
    return got, want


@pytest.mark.parametrize("w, c, esz", [(8, 2, 2), (16, 6, 2), (8, 54, 2),
                                       (4, 6, 4), (13, 8, 4), (12, 54, 4),
                                       (28, 54, 2), (23, 56, 2)])
def test_bulk_staging_reads_the_tile(w, c, esz):
    """The forward's bulk mode: at every column tile and row strip, one
    copy a row inside the frame, never past the row's end, and each
    thread's masked taps read the frame's pair at its pixel, zero outside
    the frame, never a stale or neighbouring byte."""
    assert w * c * esz % 16 == 0
    h = 5
    for wb in (2, 3, 7):
        wo = (w - 1) // 2 + 1
        for w0 in range(0, wo, wb):
            for r, h0 in ((2, 0), (2, 2), (3, 3)):
                got, want = _bulk_reads(w, c, esz, wb, r, h, h0, w0, w0 + r)
                assert got == want, (wb, w0, r, h0)


def _tile_written(w, c, esz, wb, r, h, h0, w0, seed):
    """plain_t2_dx_kernel's tile mode on one dx frame of a (h, w, c) dx:
    each thread's put of its sums (element ids here) into the tile at its
    rows 2r+py and columns 2wl+px (those inside dx), then the write-out onto
    a frame of stale bytes: t2_tile_bulk's one copy of each row's 16-byte
    aligned middle and its elements before and after.  Returns (frame bytes, the bytes dx must
    hold, the write count of each byte, which bytes lie in the tile)."""
    rng = np.random.RandomState(seed)
    dt = {2: np.uint16, 4: np.uint32}[esz]
    tb = 16 * (2 * wb * c * esz // 16 + 2)
    d = 2 * w0 * c * esz % 16
    ids = (np.arange(h * w * c) % 50000 + 1).astype(dt).reshape(h, w, c)
    tile = np.full((2 * r, tb), 0xCD, np.uint8)
    for wl in range(wb):
        j = w0 + wl
        for pi in range(c // 2):
            for rr in range(2 * r):
                for px in range(2):
                    row, col = 2 * h0 + rr, 2 * j + px
                    if row < h and col < w:
                        e = d + (2 * wl + px) * c * esz + 2 * pi * esz
                        tile[rr, e:e + 2 * esz] = ids[
                            row, col, 2 * pi:2 * pi + 2].view(np.uint8)
    frame = rng.randint(0, 256, h * w * c * esz).astype(np.uint8)
    want, count = frame.copy(), np.zeros(frame.size, np.int32)
    nrows, nq = min(2 * r, h - 2 * h0), min(2 * wb, w - 2 * w0)
    n = nq * c * esz
    lo = min(-(-d // 16) * 16, d + n)
    hi = max((d + n) // 16 * 16, lo)
    assert hi <= tb
    for rr in range(nrows):
        g = ((2 * h0 + rr) * w + 2 * w0) * c * esz - d
        assert (g + lo) % 16 == 0 and (hi - lo) % 16 == 0
        frame[g + lo:g + hi] = tile[rr, lo:hi]
        count[g + lo:g + hi] += 1
        for e in list(range(d, lo, esz)) + list(range(hi, d + n, esz)):
            frame[g + e:g + e + esz] = tile[rr, e:e + esz]
            count[g + e:g + e + esz] += 1
    run = want.reshape(h, w, c * esz)
    run[2 * h0:2 * h0 + nrows, 2 * w0:2 * w0 + nq] = ids.view(np.uint8).reshape(
        h, w, c * esz)[2 * h0:2 * h0 + nrows, 2 * w0:2 * w0 + nq]
    inside = np.zeros((h, w, c * esz), bool)
    inside[2 * h0:2 * h0 + nrows, 2 * w0:2 * w0 + nq] = True
    return frame, want, count, inside.reshape(-1)


@pytest.mark.parametrize("w, c, esz", [(8, 2, 2), (28, 54, 2), (23, 56, 2),
                                       (14, 54, 4), (7, 8, 4), (12, 6, 2)])
def test_dx_tile_write_out_covers_the_tile_once(w, c, esz):
    """The dx's tile mode (rows 16-byte aligned, the group the pixel), its
    runs out by bulk copies: at every row strip and column tile, ragged ones and runs that start and end off a 16-byte
    boundary included, every dx element of the block's tile is written once
    with its own sum, and no byte outside the tile is written (the
    neighbouring blocks write there)."""
    assert w * c * esz % 16 == 0
    wo = (w - 1) // 2 + 1
    for h, r in ((7, 2), (9, 3), (8, 4)):
        ho = (h - 1) // 2 + 1
        for wb in (2, 3, 5):
            for w0 in range(0, wo, wb):
                for h0 in range(0, ho, r):
                    frame, want, count, inside = _tile_written(
                        w, c, esz, wb, r, h, h0, w0, h0 + w0)
                    at = (wb, w0, r, h0)
                    assert (count[inside] == 1).all(), at
                    assert (count[~inside] == 0).all(), at
                    assert np.array_equal(frame, want), at


def test_the_source_has_the_walks():
    src = (dw_conv.LIBRARY_S2.source).read_text()
    for name in ("plain_t2_fwd_kernel", "plain_t2_dx_kernel",
                 "plain_t2_wgrad_kernel", 'extern "C" int dw_conv_t2(',
                 'extern "C" int dw_conv_dx_t2(',
                 'extern "C" int dw_conv_wgrad_t2(', "t2f_frame<T, R, 0, -1>",
                 "t2f_frame<T, R, 1, -1>", "t2f_frame<T, R, 2, 0>",
                 "t2dx_frame<T, R, 0>", "t2dx_frame<T, R, 1>",
                 "t2_bulk_whole(", "t2_tile_bulk("):
        assert name in src, name
    # the forward's walk and ring (_fwd_walk) and the launchers' modes
    for text in ("constexpr int T2F_AHEAD = 1;",
                 "constexpr int T2F_SLOTS = 2 * (T2F_AHEAD + 1);",
                 "    if (s == 0) stage(0);\n    stage(2 * s + 1);\n"
                 "    stage(2 * s + 2);",
                 "mbar_wait(bar + i % T2F_SLOTS, (unsigned)(i / T2F_SLOTS) & 1u);",
                 "    wait(2 * s + 1);\n    __syncthreads();\n"
                 "    load(s + T2F_AHEAD);",
                 "    wait(2 * s + 2);\n    if (live && f0 + 2 * s + 2 < Tn)",
                 "if (live && f0 + 2 * s + 2 < Tn)",
                 "const auto kern = t2_fwd_kernel_of<T>(R, whole);",
                 "const auto kern = t2_dx_kernel_of<T>(R, whole);",
                 "(whole && !t2_rows_whole<T>(x, p, W, C, PG))",
                 "(whole && !t2_rows_whole<T>(dx, p, W, C, PG))",
                 # the dx's barriers and tiles (_dx_walk)
                 "    put(2 * o, df, acc);\n    cp_wait<GSTAGE_T2 - 3>();",
                 "    load(i + GSTAGE_T2 - 1);  // into slot i-1\n"
                 "    out(2 * o, df);",
                 "tiles + (ox & 1) * 2 * R * tb"):
        assert text in src, text
    # the stride-(1, 2, 2) bodies have no temporal stride parameter
    assert "int ST" not in src
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
    assert dw_conv.T2F_SLOTS == 2 * (dw_conv.T2F_AHEAD + 1) == 4


# ---- the work splits and the wrappers -------------------------------------------

# the four t_downsample entries of FineNet at B32 T16 224² and B64 T16 112²,
# and ragged ones
PLAN_SHAPES = [(32, 16, 112, 112, 54), (32, 8, 56, 56, 108),
               (32, 4, 28, 28, 216), (32, 2, 14, 14, 432),
               (64, 16, 56, 56, 54), (64, 8, 28, 28, 108),
               (64, 4, 14, 14, 216), (64, 2, 7, 7, 432),
               (3, 9, 13, 11, 30), (2, 5, 9, 7, 7), (1, 1, 3, 3, 2),
               (3, 9, 30, 28, 54), (2, 7, 27, 23, 56)]


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
    p2 = (c + 1) // 2
    for plan, smem in ((dw_conv.plan_t2_fwd, dw_conv.smem_t2_fwd),
                       (dw_conv.plan_t2_dx, dw_conv.smem_t2_dx)):
        p = plan(*shape)
        assert smem(p, 4) <= dw_conv.SMEM_MAX
        # channel pairs first: the whole pixel up to T2_WHOLE_PG pairs
        # (where the modes that stage or write whole pixels apply), wider
        # ones in groups of at most DX_PG
        if p2 <= dw_conv.T2_WHOLE_PG:
            assert p.pg == p2 and p.n_pg == 1
        else:
            assert p.pg <= dw_conv.DX_PG
        # two blocks an SM in bf16
        assert 2 * (smem(p, 2) + 1024) <= dw_conv.SMEM_SM
    # the path's first two entries and the whole-pixel ragged ones stage
    # and write whole pixels (the wrappers' mode), rows off a 16-byte
    # boundary never: a tensor of the shape over one element's storage, at
    # its start and one element on
    for esz, dtype in ((2, torch.bfloat16), (4, torch.float32)):
        one = torch.zeros(2, dtype=dtype)
        rows_ok = w * c * esz % 16 == 0 and p2 <= dw_conv.T2_WHOLE_PG
        for plan in (dw_conv.plan_t2_fwd, dw_conv.plan_t2_dx, dw_conv.plan_t2):
            p = plan(*shape)
            assert dw_conv.t2_whole(p, one[:1].expand(shape)) == (
                rows_ok and c % 2 == 0 and p.n_pg == 1), plan.__name__
            assert not dw_conv.t2_whole(p, one[1:].expand(shape))
    p = dw_conv.plan_t2(*shape)
    assert dw_conv.smem_t2(p, 4) <= dw_conv.SMEM_MAX
    # one segment a clip, channel pairs first: a pixel of at most
    # T2_WHOLE_PG pairs in one group (where its shared memory fits), wider
    # ones in groups of at most DX_PG
    assert p.tt == to and p.n_tseg == 1
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
