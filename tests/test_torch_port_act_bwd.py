"""The two backward kernels of the act train entry on the row-strip layout:
``dw_act_dx_s2`` (K5, the act mode of K8 in ``csrc/dw_plain_s2.cu``) and
``dw_act_wgrad_s1`` (K6 act, the act mode of K6 plain in
``csrc/dw_plain_s1.cu``): the work split K5's wrapper computes, the order
of K5's sums, the premises of the card's exact oracles, the bindings and
the sources.  The kernels themselves run only on the card, where
``chip_smoke.py`` holds K5's dx against K8 (``dw_conv_dx_s2``) run in f32,
masked and scaled, and K6 act against K6 plain (``dw_conv_wgrad_s1``) on
the activated x, each with a difference of 0.

* ``plan_act_dx_s2`` covers every position of g, whose quads of dx rows and
  columns partition dx, and every channel exactly once, one block per tile
  and channel group, with channel pairs first (at most ``DX_PG``), at most
  ``NT_DX`` threads and the card's shared memory in f32 and bf16, at the 8
  stride-2 entry shapes of the coarse train step and of long-cycle phase D
  and at ragged ones; its partial buffer has one row per item.  K6 act
  takes ``plan_s1``, K6 plain's split.
* A torch model of K5 (K8's per-quad order with fused adds, masked by
  ``x·sc + bi > 0`` rounded apart, scaled, with the sums) against
  ``dw_act_dx_plain`` and the JAX Pallas kernel K5 (``_dx_s2_act_raw``)
  interpreted, at 1e-5 (f32 sums of up to 27 terms, and of the sums over
  every position, in other orders); the same model without the mask is K8's
  order, which equals K11 on the zero-upsampled g exactly
  (``test_torch_port_plain_s2_fwd_dx.py``).
* ``dw_act_wgrad_plain`` equals ``dw_conv_wgrad_plain`` on the activated x
  exactly (the card's oracle), in f32 and bf16; with every ``bi > 0`` (so a
  padding of relu(bi) would show) it matches the JAX Pallas kernel K6 in act
  mode (``_dw_fold4_wgrad_raw``) interpreted at 1e-4; and a torch model of
  the act kernels' ring (:func:`act_ring_reads`: zeroed, in-frame pairs
  copied and activated in place a frame ahead) gives the stencil the zero
  padding of a for sc of either sign or 0, with an in-frame NaN kept.
* The wrappers take the plain versions on the CPU and count no launch; the
  bindings match the C declarations; the constants the plans mirror are the
  sources'; the entry backward's tile source (``dw_act_bwd.cu``) and the
  tile layout are gone: every weight gradient is a row-strip body's.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from coarse_fine_networks_tpu.ops.fold import (FOLD, fold_pad, from_fold4,
                                               pad_vec, to_fold4)
from coarse_fine_networks_tpu.ops.pallas.dw_fold import (
    _dw_fold4_wgrad_raw, _dx_s2_act_raw, _prep_lane_weights)
from coarse_fine_networks_torch.ops import (dw_act, dw_conv, dw_stencil,
                                            frame_decode, scaled_decode)
from coarse_fine_networks_torch.ops.dw_act import (_activate, dw_act_dx,
                                                   dw_act_dx_plain,
                                                   dw_act_wgrad,
                                                   dw_act_wgrad_plain)
from coarse_fine_networks_torch.ops.dw_conv import (
    DX_PG, FWD_BLOCKS, NT_DX, RMAX, RMIN, SMEM_MAX, TT_MIN,
    dw_conv_wgrad_plain, plan_act_dx_s2, smem_act_dx_s2)

from _torch_port_util import t
from test_torch_port_plain_s2_fwd_dx import _k8_model

torch.set_num_threads(2)


def _out(h):
    return (h - 1) // 2 + 1


# ---- K5's work split ---------------------------------------------------------------

# (label, B, T, H, W, C) of x at K5's entries: the coarse train step's
# stride-2 blocks (T=64 in layer1, T=17 after Grid Pool) and long-cycle
# phase D's (B8 T64 224², every stage at T=64), then ragged ones
PATH = [("coarse.layer1.0", 8, 64, 112, 112, 54),
        ("coarse.layer2.0", 8, 17, 56, 56, 108),
        ("coarse.layer3.0", 8, 17, 28, 28, 216),
        ("coarse.layer4.0", 8, 17, 14, 14, 432),
        ("D.layer1.0", 8, 64, 112, 112, 54),
        ("D.layer2.0", 8, 64, 56, 56, 108),
        ("D.layer3.0", 8, 64, 28, 28, 216),
        ("D.layer4.0", 8, 64, 14, 14, 432)]
RAGGED = [("7x7.c13", 2, 5, 7, 7, 13), ("9x5.c12", 1, 3, 9, 5, 12),
          ("one_pixel", 3, 1, 1, 1, 1), ("wide", 1, 3, 4, 600, 6),
          ("odd_c", 2, 9, 9, 9, 7), ("long_clip", 1, 80, 6, 6, 10),
          ("wide_c", 1, 2, 2, 2, 1024)]
SHAPES = PATH + RAGGED


def _partitions(spans, n):
    """The distinct intervals ``spans`` cover ``[0, n)`` once each."""
    got = sorted(set(spans))
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(got, got[1:]))
    return len(got)


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_covers_every_dx_once(shape):
    """One block per (item, channel group) over g: each block's tile,
    clipped to g, is a product of one interval per axis; the intervals of
    each axis partition it and every combination occurs once, so every g
    position and channel is owned exactly once, and g row i (column j) owns
    dx rows 2i, 2i+1 (columns 2j, 2j+1) inside (H, W), which partition dx.
    The split is within the kernel's limits and the card's shared memory in
    f32 and bf16, takes channel pairs first, and has one partial row per
    item."""
    _, b, tt, h, w, c = shape
    p = plan_act_dx_s2(b, tt, h, w, c)
    ho, wo, p2 = _out(h), _out(w), -(-c // 2)
    assert (p.b, p.t, p.h, p.w, p.c) == (b, tt, ho, wo, c)
    assert RMIN <= p.r <= RMAX and p.wb * p.pg <= NT_DX
    assert p.threads <= NT_DX
    assert p.pg <= min(p2, DX_PG) and p.wb <= wo and (p.wb >= 2 or wo == 1)
    assert p.ipb == 1 and p.rows == p.items
    for esz in (2, 4):
        assert smem_act_dx_s2(p, esz) <= SMEM_MAX
    # frames: the whole clip unless that gives under two waves of two
    # blocks per SM, never split below TT_MIN
    assert p.tt == tt or (p.tt >= min(TT_MIN, tt) and
                          p._replace(tt=2 * p.tt).items * p.n_pg
                          < FWD_BLOCKS)
    tiles = [p.tile(item, g) for item in range(p.items)
             for g in range(p.n_pg)]
    assert len(set(tiles)) == len(tiles) == p.items * p.n_pg
    counts = [_partitions([tile[1 + a] for tile in tiles], n)
              for a, n in enumerate((tt, ho, wo, c))]
    assert len({tile[0] for tile in tiles}) == b
    assert len(tiles) == b * int(np.prod(counts))
    for n, size, full in ((p.r, p.h, h), (p.wb, p.w, w)):
        got = [i for s0 in range(0, size, n)
               for i in range(2 * s0, min(2 * min(s0 + n, size), full))]
        assert got == list(range(full))


def test_split_of_the_first_path_entry():
    """Layer1's stride-2 entry (x B8 T64 112² C54, g 56²): all 27 channel
    pairs in one group, 7 g columns (189 threads, 6 warps: K8 takes 8 and
    224), strips of 4 g rows, the whole clip per block: 896 blocks, and
    a bf16 block's g ring and x ring in 57,888 bytes."""
    p = plan_act_dx_s2(8, 64, 112, 112, 54)
    assert (p.r, p.wb, p.pg, p.n_pg, p.n_wt, p.tt) == (4, 7, 27, 1, 8, 64)
    assert p.items * p.n_pg == 896 and p.threads == 192
    assert smem_act_dx_s2(p, 2) == 57888
    q = dw_conv.plan_s2_dx(8, 64, 112, 112, 54)
    assert (q.wb, q.threads) == (8, 224)


# ---- K5's order ---------------------------------------------------------------------

def _k5_model(g, x, w, sc, bi):
    """K5 in the kernel's order: da K8's f32 gather with fused adds, dam =
    da where x·sc + bi > 0 (the product and the sum rounded to f32 apart),
    dx = dam·sc in x's dtype, and the f32 sums (Σ dam·x, Σ dam)."""
    da = _k8_model(g.float(), w.float(), tuple(x.shape[2:4]), fused=True)
    xf = x.float()
    dam = torch.where(xf * sc + bi > 0, da, torch.zeros_like(da))
    red = torch.stack([torch.sum(dam * xf, dim=(0, 1, 2, 3)),
                       torch.sum(dam, dim=(0, 1, 2, 3))])
    return (dam * sc).to(x.dtype), red


def _inputs(shape, seed, dtype=torch.float32, bi_positive=False):
    """x, taps, sc, bi and g at stride 2 (or 1 with ``bi_positive``); half
    the channels get a negative bi unless ``bi_positive``."""
    rng = np.random.RandomState(seed)
    b, tt, h, w, c = shape
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, 3, c) / np.sqrt(27)).astype(np.float32)
    sc = (rng.rand(c) + 0.5).astype(np.float32)
    bi = rng.randn(c).astype(np.float32)
    if bi_positive:
        bi = np.abs(bi) + 0.25
    else:
        bi[: c // 2] = -np.abs(bi[: c // 2]) - 0.5
    s = 1 if bi_positive else 2
    g = rng.randn(b, tt, (h - 1) // s + 1, (w - 1) // s + 1,
                  c).astype(np.float32)
    return (t(x).to(dtype), t(k).to(dtype), t(sc), t(bi), t(g).to(dtype))


ODD = [(2, 5, 7, 7, 13), (1, 3, 9, 5, 12), (1, 4, 8, 7, 54)]


@pytest.mark.parametrize("shape", ODD, ids=["x".join(map(str, s))
                                            for s in ODD])
def test_k5_order_matches_the_plain_version(shape):
    """The model against ``dw_act_dx_plain`` at odd H and W: dx and the
    sums at 1e-5 of their largest magnitude (f32 sums in other orders; the
    relu test is the same rounded apply on both sides)."""
    x, k, sc, bi, g = _inputs(shape, seed=sum(shape))
    dx, red = _k5_model(g, x, k, sc, bi)
    ref_dx, ref_red = dw_act_dx_plain(g, x, k, sc, bi, 2)
    assert dx.shape == ref_dx.shape == shape
    np.testing.assert_allclose(dx.numpy(), ref_dx.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(red.numpy(), ref_red.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref_red.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_order_is_k8s_masked_and_scaled(dtype):
    """The card's oracle: K5's dx is K8's f32 dx (here its order model on
    g and the taps read as f32) where x·sc + bi > 0, times sc, rounded to
    x's dtype once; the plain version's mask and rounding are the same, so
    in bf16 the two agree to one bf16 rounding of K8's order."""
    x, k, sc, bi, g = _inputs((1, 4, 8, 7, 54), seed=9, dtype=dtype)
    dx, _ = _k5_model(g, x, k, sc, bi)
    da = _k8_model(g.float(), k.float(), (8, 7), fused=True)
    want = (torch.where(x.float() * sc + bi > 0, da, 0) * sc).to(dtype)
    assert dx.dtype == dtype and torch.equal(dx, want)
    ref_dx, _ = dw_act_dx_plain(g, x, k, sc, bi, 2)
    eps = 1e-5 if dtype == torch.float32 else 2 ** -8
    np.testing.assert_allclose(dx.float().numpy(), ref_dx.float().numpy(),
                               rtol=eps, atol=eps)


def _phase_sum(v, c):
    """(…, 4P) per-lane sums → (…, C) per-channel sums."""
    v = np.asarray(v)
    return v.reshape(v.shape[:-1] + (FOLD, v.shape[-1] // FOLD)).sum(-2)[
        ..., :c]


@pytest.mark.parametrize("shape", [(1, 3, 8, 8, 12), (2, 2, 16, 8, 54)],
                         ids=["1x3x8x8x12", "2x2x16x8x54"])
def test_k5_order_matches_pallas_interpret(shape):
    """The model against the JAX Pallas kernel K5 itself
    (``_dx_s2_act_raw``: K8's gather with the mask, the scale and the
    per-batch partial sums), interpreted, at 1e-5 (f32 sums in another
    order); it takes even g sizes only."""
    x, k, sc, bi, g = _inputs(shape, seed=sum(shape) + 3)
    c = shape[-1]
    p = fold_pad(c)
    dx, red = _dx_s2_act_raw(
        to_fold4(jnp.asarray(g.numpy()), p),
        _prep_lane_weights(jnp.asarray(k.numpy()).reshape(3, 3, 3, 1, c), c,
                           p), True,
        sc=pad_vec(jnp.asarray(sc.numpy()), c, p),
        bi=pad_vec(jnp.asarray(bi.numpy()), c, p),
        x2=to_fold4(jnp.asarray(x.numpy()), p))
    got_dx, got_red = _k5_model(g, x, k, sc, bi)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(from_fold4(dx, c)),
                               rtol=1e-5, atol=1e-5)
    want_red = _phase_sum(np.asarray(red).sum(0), c)
    np.testing.assert_allclose(got_red.numpy(), want_red, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_red).max()))


# ---- K6 act ---------------------------------------------------------------------------

WG_SHAPES = [(2, 4, 9, 7, 13), (1, 5, 8, 8, 54), (1, 3, 1, 1, 6)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WG_SHAPES, ids=["x".join(map(str, s))
                                                  for s in WG_SHAPES])
def test_act_wgrad_is_plain_wgrad_of_the_activation(shape, dtype):
    """The premise of the card's oracle: the act weight gradient is K6
    plain's on ``relu(x·sc + bi)`` rounded to x's dtype, exactly."""
    x, _, sc, bi, _ = _inputs(shape, seed=sum(shape) + 5, dtype=dtype)
    g = t(np.random.RandomState(1).randn(*shape).astype(np.float32)).to(
        dtype)
    got = dw_act_wgrad_plain(x, g, sc, bi, 1)
    want = dw_conv_wgrad_plain(_activate(x, sc, bi), g, 1)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_act_wgrad_pads_the_activation_with_zero():
    """With every bi > 0, relu(bi) > 0 in every channel, so a padding of
    the activated x other than 0 moves every edge tap: the plain version
    matches the JAX Pallas kernel K6 in act mode (``_dw_fold4_wgrad_raw``)
    interpreted at 1e-4 (f32 sums of 2·4·16·16 positions in another
    order), and the weight gradient of a padded with relu(bi) (the
    activation applied after the zero padding of x) does not."""
    shape = (2, 4, 16, 16, 12)
    x, _, sc, bi, g = _inputs(shape, seed=77, bi_positive=True)
    c = shape[-1]
    dk = _dw_fold4_wgrad_raw(to_fold4(jnp.asarray(x.numpy())),
                             to_fold4(jnp.asarray(g.numpy())), True,
                             sc=pad_vec(jnp.asarray(sc.numpy()), c,
                                        fold_pad(c)),
                             bi=pad_vec(jnp.asarray(bi.numpy()), c,
                                        fold_pad(c)))
    got = dw_act_wgrad_plain(x, g, sc, bi, 1)
    ref = _phase_sum(dk, c)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    # the activation of a zero-padded x: relu(bi) on the padding
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    ap = torch.relu(xp * sc + bi)
    wrong = torch.stack([
        torch.einsum("bthwc,bthwc->c",
                     ap[:, dt:dt + 4, dy:dy + 16, dx:dx + 16], g)
        for dt in range(3) for dy in range(3) for dx in range(3)])
    assert not np.allclose(wrong.numpy(), ref, rtol=1e-2, atol=1e-2)


def _ring_schedule():
    """``NSTAGE_ACT`` and ``act_own``'s ``cp_wait`` depth as
    ``csrc/strip.cuh`` writes them, once each asserted to be the order of
    the act kernels' frame loops (``dw_plain_s1.cu``, ``dw_plain_s2.cu``):
    ``act_own(own, 0)`` before the loop; in step i the barrier, then
    ``load(i + NS - 1)``, then ``act_own(own, i + 1)``."""
    csrc = dw_conv.LIBRARY.source.parent
    src = (csrc / "strip.cuh").read_text()
    ns = int(re.search(r"constexpr int NSTAGE_ACT = NSTAGE \+ (\d+);",
                       src).group(1)) + dw_conv.NSTAGE
    body = src[src.index("void act_own("):]
    depth = ns - int(re.search(r"cp_wait<NSTAGE_ACT - (\d+)>", body).group(1))
    loops = 0
    for f in ("dw_plain_s1.cu", "dw_plain_s2.cu"):
        text = (csrc / f).read_text()
        for m in re.finditer(r"act_own\(own, 0\);\s*for \(int i = 0; i < nf; "
                             r"\+\+i\) \{(.*?)_frame<T, R[>,]", text, re.S):
            step = re.sub(r"//[^\n]*", "", m.group(1))
            at = [step.index(k) for k in ("__syncthreads();",
                                          "load(i + NS - 1);",
                                          "act_own(own, i + 1);")]
            assert at == sorted(at), f
            loops += 1
    assert loops == 4  # K1 act, K6 act, K4 act, K10 act
    return ns, depth, depth


def act_ring_reads(x, sc, bi, rows, cols, t0, t1):
    """A torch model of the act kernels' ring (``csrc/strip.cuh``'s
    ``act_own`` and the kernels' frame loop, :func:`_ring_schedule`) for one tile of
    one sample ``x (T, H, W, C)``: the tile stages input rows ``rows`` and
    columns ``cols`` (which may run past the frame) of input frames t0-1 ..
    t1 into a zeroed ring of ``NSTAGE_ACT`` slots; a copy lands at any time
    between its commit (``load``) and the ``cp_wait`` that covers it; each
    frame's copies are activated in place (``own``) once landed.  Between
    barriers i and i + 1 the block commits frame i + NSTAGE_ACT - 1,
    activates frame i + 1 and reads frame i's slot.  Asserts that no copy
    in flight, activation or read of one interval meets another's slot, and
    returns the slots as the stencil reads them, one per frame in the clip,
    in x's dtype."""
    ns, w_pro, w_ahead = _ring_schedule()
    T, H, W, C = x.shape
    rin = [r for r, h in enumerate(rows) if 0 <= h < H]
    cin = [q for q, w in enumerate(cols) if 0 <= w < W]
    frame = lambda ti: x[ti][[rows[r] for r in rin]][:, [cols[q] for q in cin]]
    ring = torch.zeros((ns, len(rows), len(cols), C), dtype=x.dtype)
    f0, nf = t0 - 1, t1 - t0 + 2
    clip = lambda i: i < nf and 0 <= f0 + i < T
    pending, landed, reads = [], set(), []

    def wait(n):  # all but the newest n groups have landed
        while len(pending) > n:
            i = pending.pop(0)
            if clip(i):
                ring[i % ns][np.ix_(rin, cin)] = frame(f0 + i)
                landed.add(i)

    def own(i):
        if not clip(i):
            return
        assert i in landed
        v = ring[i % ns][np.ix_(rin, cin)]
        ring[i % ns][np.ix_(rin, cin)] = torch.relu(
            v.float() * sc + bi).to(x.dtype)

    pending.extend(range(ns - 1))  # load(0 .. ns - 2)
    wait(w_pro)
    own(0)
    for i in range(nf):
        # the barrier; then this interval's copy, activation and read
        pending.append(i + ns - 1)
        wait(w_ahead)
        own(i + 1)
        if clip(i):
            slots = [j % ns for j in pending if clip(j)]
            assert i % ns not in slots and (i + 1) % ns not in slots
            assert (i + 1) % ns != i % ns
            reads.append(ring[i % ns].clone())
    return reads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_ring_padding_activates_to_zero(dtype):
    """The act kernels' padding no longer rests on a NaN ring (which only a
    relu that drops NaN, ``fmaxf``, mapped to 0): the ring is zeroed, only
    positions inside the frame are copied and activated in place a frame
    ahead, so what the stencil reads of every frame (the torch model
    :func:`act_ring_reads` of the kernels' schedule) is the activated x
    zero-padded after the activation, for sc of either sign or 0 and every
    bi > 0 (a padding of relu(bi) would show), exactly; a NaN x inside the
    frame stays NaN, as ``torch.relu`` and the JAX package's
    ``jnp.maximum`` keep it.  Tiles at the frame's corner, inside it and
    past its far edge; the clip's first and last segments."""
    rng = np.random.RandomState(4)
    x = t(rng.randn(1, 5, 6, 7, 8).astype(np.float32)).to(dtype)[0]
    x[2, 3, 4, 5] = float("nan")
    sc = t(rng.randn(8).astype(np.float32))  # either sign
    sc[3] = 0.0
    bi = t(np.abs(rng.randn(8)).astype(np.float32) + 0.25)
    want = F.pad(_activate(x[None], sc, bi)[0].float(),
                 (0, 0, 1, 1, 1, 1, 1, 1)).to(dtype)  # (T+2, H+2, W+2, C)
    assert torch.isnan(want[3, 4, 5, 5]) and torch.isnan(want).sum() == 1
    for h0, r, w0, wb in ((0, 2, 0, 3), (2, 3, 2, 4), (4, 4, 5, 3)):
        rows = list(range(h0 - 1, h0 + r + 1))
        cols = list(range(w0 - 1, w0 + wb + 1))
        for t0, t1 in ((0, 3), (3, 5)):
            reads = act_ring_reads(x, sc, bi, rows, cols, t0, t1)
            ti = [f for f in range(t0 - 1, t1 + 1) if 0 <= f < 5]
            assert len(reads) == len(ti)
            for f, got in zip(ti, reads):
                ref = torch.zeros_like(got)
                hs = [q for q, h in enumerate(rows) if -1 <= h <= 6]
                ws = [q for q, w in enumerate(cols) if -1 <= w <= 7]
                ref[np.ix_(hs, ws)] = want[f + 1][
                    [rows[q] + 1 for q in hs]][:, [cols[q] + 1 for q in ws]]
                assert torch.equal(torch.isnan(got), torch.isnan(ref))
                fin = ~torch.isnan(ref)
                assert torch.equal(got[fin], ref[fin])


# ---- the wrappers, the bindings, the sources ---------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_cpu_take_plain_and_count_nothing(dtype):
    """On a CPU tensor both wrappers return their plain version and launch
    nothing."""
    dw_act.reset_launches()
    x, k, sc, bi, g2 = _inputs((1, 3, 7, 6, 10), seed=8, dtype=dtype)
    g1 = t(np.random.RandomState(2).randn(1, 3, 7, 6, 10).astype(
        np.float32)).to(dtype)
    for got, ref in zip(dw_act_dx(g2, x, k, sc, bi, 2),
                        dw_act_dx_plain(g2, x, k, sc, bi, 2)):
        assert torch.equal(got, ref)
    assert torch.equal(dw_act_wgrad(x, g1, sc, bi, 1),
                       dw_act_wgrad_plain(x, g1, sc, bi, 1))
    assert not any(dw_act.LAUNCHES.values())


BOUND = [(dw_conv.LIBRARY, "dw_act_wgrad_s1"),
         (dw_conv.LIBRARY, "dw_plain_s1_occupancy"),
         (dw_conv.LIBRARY_S2, "dw_act_dx_s2"),
         (dw_conv.LIBRARY_S2, "dw_plain_s2_occupancy"),
         (dw_stencil.LIBRARY, "dw_stencil_partial_rows"),
         (dw_conv.LIBRARY_S2, "dw_mm_wgrad_s2")]


@pytest.mark.parametrize("lib,name", BOUND, ids=[n for _, n in BOUND])
def test_bindings_match_the_c_declarations(lib, name):
    """A pointer for each ``void*``, an int for each ``int``, in order."""
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % name,
                  lib.source.read_text())
    assert m, name
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in m.group(1).split(",")]
    assert lib.functions[name] == want


@pytest.mark.parametrize("name,value", [("NT_DX", NT_DX),
                                        ("GSTAGE", dw_conv.GSTAGE),
                                        ("XSTAGE", dw_conv.XSTAGE),
                                        ("SMEM_MAX", SMEM_MAX)])
def test_constants_match_the_source(name, value):
    """The limits ``plan_act_dx_s2`` keeps and the ring depths
    ``smem_act_dx_s2`` counts are the launcher's."""
    src = dw_conv.LIBRARY_S2.source
    text = src.read_text() + (src.parent / "strip.cuh").read_text()
    m = re.search(r"constexpr int %s = (\d+);" % name, text)
    assert m and int(m.group(1)) == value


def test_kernels_left_the_entry_backward_source():
    """The entry backward's tile source (``dw_act_bwd.cu``) is gone with its
    last kernel, K10 mm: no source in ``csrc/`` defines the tile layout
    (``CC``, ``WARPS``, ``KC``, ``unpack``, ``mm_prologue``,
    ``StencilGeom``, ``slot_of``), and the libraries are the five depthwise
    sources beside the native data plane's decoders (the crop's and the
    fast decode's).  Every weight gradient of both train entries is a row-strip body's: K6
    act and K10 act the act instantiations of K6 and K10 plain, K6 mm
    ``dw_plain_s1.cu``'s mm kernel and K10 mm ``dw_plain_s2.cu``'s, under
    ``wgrad_slots``; K5 and K9 are the act and mm modes of K8's body,
    launched by the wrappers with their plans."""
    csrc = dw_conv.LIBRARY.source.parent
    assert not (csrc / "dw_act_bwd.cu").exists()
    libs = dw_conv.LIBRARIES + (dw_stencil.LIBRARY,)
    # the five depthwise sources, and the native data plane's decoders
    assert sorted(lib.source.name for lib in libs) == [
        "dw_dx_s1.cu", "dw_mm_act.cu", "dw_plain_s1.cu", "dw_plain_s2.cu",
        "dw_stencil.cu"]
    assert sorted(f.name for f in csrc.glob("*.cu")) == sorted(
        [lib.source.name for lib in libs]
        + [frame_decode.LIBRARY.source.name,
           scaled_decode.LIBRARY.source.name])
    for f in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        code = "\n".join(line.split("//")[0]
                         for line in f.read_text().splitlines())
        for gone in (r"\bCC\b", r"\bWARPS\b", r"\bKC\b", r"\bunpack\b",
                     r"\bmm_prologue\b", r"\bStencilGeom\b",
                     r"\bStencilTile\b", r"\bslot_of\b"):
            assert not re.search(gone, code), (f.name, gone)
    s1 = dw_conv.LIBRARY.source.read_text()
    s2 = dw_conv.LIBRARY_S2.source.read_text()
    for name in ("dw_act_dx_s2", "dw_act_wgrad_s2", "dw_mm_dx_mask_s2",
                 "dw_mm_wgrad_s2"):
        assert f'extern "C" int {name}(' in s2 and name in (
            dw_conv.LIBRARY_S2.functions)
    for name in ("dw_act_wgrad_s1", "dw_mm_wgrad_s1"):
        assert f'extern "C" int {name}(' in s1
    assert "dx_s2_body<T, R, false, true>" in s2
    assert "wgrad_body<T, R, true>" in s1 and "wgrad_body<T, R, false>" in s1
    assert "dx_s2_body<T, R, true>" in s2 and "dx_s2_body<T, R, false>" in s2
    assert ("s2_wgrad_body<T, R, true>" in s2
            and "s2_wgrad_body<T, R, false>" in s2)
    mm = s2[s2.index("mm_s2_wgrad_kernel(const T*"):]
    assert "wgrad_slots(" in mm[:mm.index("\n}\n")]
    assert "rows != items" in s2
