"""The stride-2 plain forward and dx of the split-batch-norm route
(``dw_conv_s2``, K4 plain, and ``dw_conv_dx_s2``, K8, in
``csrc/dw_plain_s2.cu``): the work splits their wrappers compute, the order
in which K8 adds its terms, and the source.  The kernels themselves run
only on the card, where ``chip_smoke.py`` holds them against their plain
versions and, with a difference of 0, K4 plain against K7 and K8 against
K11 on the zero-upsampled g with the flipped taps.

* ``plan_s2_fwd`` covers every (sample, frame, output row, output column,
  channel) of y exactly once, and ``plan_s2_dx`` (channel pairs first, so
  a warp's dx stores fill whole sectors) every position of g, whose quads
  of dx rows and columns partition dx, at the fine tower's four
  stride-2 entries of long-cycle phases A-C and at ragged ones (odd H and
  W, 7×7 → 4×4, C = 12, odd C, a width split into column tiles, a
  one-column frame of 512 channels), within the kernels' limits and their
  shared memory in f32 and bf16.
* A model of K8's per-quad gather (for each dx element its nonzero terms:
  g's 3 frames ascending, then its rows, then its columns, 27 per quad) in
  torch: with plain f32 adds it equals ``dw_conv_dx_s2_plain`` at odd sizes
  at 1e-5 (f32 sums in another order) and the JAX Pallas kernel
  (``_dx_s2_raw``, interpreted) at the sizes that takes; with each term as
  one fused multiply-add it equals ``dw_stencil3d_plain`` (K11's order) on
  the zero-upsampled g with the flipped taps exactly.
* The ring depths of the source are the wrappers'.
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from coarse_fine_networks_tpu.ops.fold import fold_pad, from_fold4, to_fold4
from coarse_fine_networks_tpu.ops.pallas.dw_fold import (_dx_s2_raw,
                                                         _prep_lane_weights)
from coarse_fine_networks_torch.ops import dw_conv
from coarse_fine_networks_torch.ops.dw_conv import (
    DX_PG, FWD_BLOCKS, NT_MAX, RMAX, RMIN, SMEM_MAX, TT_MIN,
    dw_conv_dx_s2_plain, plan_s2_dx, plan_s2_fwd, smem_s2_dx, smem_s2_fwd)
from coarse_fine_networks_torch.ops.dw_stencil import dw_stencil3d_plain

from _torch_port_util import t
from test_torch_port_plain_s2 import SHAPES

torch.set_num_threads(2)

IDS = ["x".join(map(str, s)) for s in SHAPES]


def _out(h):
    return (h - 1) // 2 + 1


def _check_split(p, shape, smem, pairs_first=False):
    """The kernels' limits, the rule of the columns and the pairs (columns
    first, or with ``pairs_first`` groups of at most ``DX_PG`` pairs first;
    the pairs cut only for f32 shared memory), the frames' rule, and every
    tile of g's or y's positions owned exactly once."""
    b, tt, h, w, c = shape
    ho, wo = _out(h), _out(w)
    assert (p.h, p.w) == (ho, wo)  # the split is over y's or g's positions
    p2 = -(-c // 2)
    assert RMIN <= p.r <= RMAX and p.wb * p.pg <= NT_MAX
    assert p.threads <= NT_MAX and p.pg <= p2
    if pairs_first:
        rule = -(-p2 // -(-p2 // DX_PG))
        assert p.wb == -(-wo // -(-wo // (NT_MAX // rule)))
    else:
        rule = -(-p2 // -(-p2 // max(1, NT_MAX // p.wb)))
    assert p.pg <= rule
    if p.pg < rule:
        assert smem(p._replace(pg=-(-p2 // (p.n_pg - 1))), 4) > SMEM_MAX
    assert p.wb <= wo and (p.wb >= 2 or wo == 1)
    # frames: the whole clip unless that gives under two waves of two
    # blocks per SM, never split below TT_MIN
    assert p.tt == tt or (p.tt >= min(TT_MIN, tt) and
                          p._replace(tt=2 * p.tt).items * p.n_pg
                          < FWD_BLOCKS)
    for esz in (2, 4):
        assert smem(p, esz) <= SMEM_MAX
    count = np.zeros((b, tt, ho, wo, 2 * p.n_pg * p.pg), np.uint8)
    for item in range(p.items):
        for g in range(p.n_pg):
            bi, (t0, t1), (h0, h1), (w0, w1), (c0, c1) = p.tile(item, g)
            assert t0 < t1 and h0 < h1 and w0 < w1
            count[bi, t0:t1, h0:h1, w0:w1, c0:c1] += 1
    assert (count[..., :c] == 1).all()
    assert not count[..., c:].any()


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plan_s2_fwd_covers_every_output_once(shape):
    """One block per tile; the tiles own every element of y once."""
    _check_split(plan_s2_fwd(*shape), shape, smem_s2_fwd)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plan_s2_dx_covers_every_dx_once(shape):
    """One block per tile of g; g row i, column j owns dx rows 2i, 2i+1 and
    columns 2j, 2j+1 inside (H, W), so the strips' and the column tiles'
    dx intervals partition H and W."""
    p = plan_s2_dx(*shape)
    _check_split(p, shape, smem_s2_dx, pairs_first=True)
    h, w = shape[2:4]
    for n, size, full in ((p.r, p.h, h), (p.wb, p.w, w)):
        got = [i for s0 in range(0, size, n)
               for i in range(2 * s0, min(2 * min(s0 + n, size), full))]
        assert got == list(range(full))


def test_dx_split_of_the_first_path_entry():
    """Phase A's layer1.0 dx (B64 T16 56² C54, g 28²): all 27 channel
    pairs in one group, so a warp's dx stores are runs of whole columns, by
    four tiles of 7 g columns (14 dx columns), strips of 4 g rows (8 dx
    rows), the whole clip per block: 1,792 blocks of 189 threads."""
    p = plan_s2_dx(64, 16, 56, 56, 54)
    assert (p.r, p.wb, p.pg, p.n_pg, p.n_wt, p.tt) == (4, 7, 27, 1, 4, 16)
    assert p.items * p.n_pg == 1792 and p.threads == 192


def _k8_model(g, w, hw, fused):
    """K8's gather in the kernel's order: per dx frame o, g frames o-1, o,
    o+1 (taps dt = 2, 1, 0), in each its rows i, i+1 and columns j, j+1
    ascending; each dx element adds only its nonzero terms (the even row
    through dy = 1 on row i, the odd one through dy = 2 on row i and dy =
    0 on row i+1; columns alike).  ``fused``: each term as one fused
    multiply-add (the f64 sum of the f32 sum and the exact product, rounded
    to f32); else f32 multiply, then add."""
    b, tn, ho, wo, c = g.shape
    gp = F.pad(g.double(), (0, 0, 0, 1, 0, 1, 1, 1))  # frames -1..T, row ho
    wd = w.double()
    acc = torch.zeros((b, tn, ho, 2, wo, 2, c), dtype=torch.float32)
    # (parity, g row or column offset) -> tap: even through 1; odd through
    # 2 on offset 0, then 0 on offset 1
    taps = {(0, 0): 1, (1, 0): 2, (1, 1): 0}
    for f in range(3):
        dt = 2 - f
        for rr in (0, 1):
            for cc in (0, 1):
                v = gp[:, f:f + tn, rr:rr + ho, cc:cc + wo]
                for py in (0, 1):
                    for px in (0, 1):
                        if (py, rr) not in taps or (px, cc) not in taps:
                            continue
                        k = wd[dt, taps[py, rr], taps[px, cc]]
                        prev = acc[:, :, :, py, :, px]
                        if fused:
                            new = (prev.double() + v * k).float()
                        else:
                            new = prev + (v * k).float()
                        acc[:, :, :, py, :, px] = new
    dx = acc.reshape(b, tn, 2 * ho, 2 * wo, c)
    return dx[:, :, :hw[0], :hw[1]]


def _gw(shape, seed):
    rng = np.random.RandomState(seed)
    b, tn, h, w, c = shape
    g = rng.randn(b, tn, _out(h), _out(w), c).astype(np.float32)
    k = (rng.randn(3, 3, 3, c) / np.sqrt(27)).astype(np.float32)
    return t(g), t(k)


ODD = [(2, 5, 7, 7, 13), (1, 3, 9, 5, 12), (1, 4, 8, 7, 54)]


@pytest.mark.parametrize("shape", ODD, ids=["x".join(map(str, s))
                                            for s in ODD])
def test_k8_order_matches_the_plain_version(shape):
    """The kernel's order against ``dw_conv_dx_s2_plain`` (the correlation
    of the zero-upsampled g with the flipped taps, tap by tap), at odd H and
    W: f32 sums of up to 27 terms in another order."""
    g, k = _gw(shape, seed=sum(shape))
    got = _k8_model(g, k, shape[2:4], fused=False)
    ref = dw_conv_dx_s2_plain(g, k, shape[2:4])
    assert got.shape == ref.shape == shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", ODD, ids=["x".join(map(str, s))
                                            for s in ODD])
def test_k8_order_is_k11s_on_the_upsampled_g(shape):
    """With fused adds the kernel's order gives exactly what K11's order
    (``dw_stencil3d_plain``: frames, rows, columns ascending, a zero term
    adding nothing) gives on g at the even positions of a zero (B, T, H, W,
    C) tensor with the flipped taps: the card's exact check of K8 against
    ``dw_stencil_s1``."""
    g, k = _gw(shape, seed=sum(shape) + 1)
    b, tn, h, w, c = shape
    up = torch.zeros(shape)
    up[:, :, ::2, ::2] = g
    ref = dw_stencil3d_plain(up, torch.flip(k, (0, 1, 2)))
    got = _k8_model(g, k, (h, w), fused=True)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", [(1, 3, 8, 8, 12), (2, 2, 16, 8, 7)],
                         ids=["1x3x8x8x12", "2x2x16x8x7"])
def test_k8_order_matches_pallas_interpret(shape):
    """The kernel's order against the JAX Pallas kernel K8 itself
    (``_dx_s2_raw``), run in interpret mode, at C = 12 and odd C (it takes
    even g sizes only)."""
    g, k = _gw(shape, seed=sum(shape) + 2)
    c = shape[-1]
    lane_w = _prep_lane_weights(jnp.asarray(k.numpy()).reshape(3, 3, 3, 1, c),
                                c, fold_pad(c))
    ref = np.asarray(from_fold4(_dx_s2_raw(
        to_fold4(jnp.asarray(g.numpy()), fold_pad(c)), lane_w, True), c))
    got = _k8_model(g, k, shape[2:4], fused=False)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,value", [("NSTAGE", dw_conv.NSTAGE),
                                        ("GSTAGE", dw_conv.GSTAGE)])
def test_ring_depths_match_the_source(name, value):
    """The shared-memory sizes the plans check are the launchers'."""
    src = dw_conv.LIBRARY_S2.source.read_text()
    strip = (dw_conv.LIBRARY_S2.source.parent / "strip.cuh").read_text()
    m = re.search(r"constexpr int %s = (\d+);" % name, src + strip)
    assert m and int(m.group(1)) == value
