"""The stride-1 dx of the train entries (``dw_act_dx_s1``, K3, and
``dw_mm_dx_mask_s1``, K2, in ``csrc/dw_dx_s1.cu``): the work splits their
wrappers compute, the order in which the kernels add each output's taps,
the bindings and the sources.  The kernels themselves run only on the card,
where ``chip_smoke.py`` holds K3's dx and K2's dam against ``dw_conv_s1`` of
g with the flipped taps (masked as the plain versions mask it, K2 by K1
``mm``'s relu branch) with a difference of 0.

* ``plan_act_dx_s1`` and ``plan_mm_dx_s1`` (f32 and bf16) cover every
  (sample, frame, row, column, channel) of dx exactly once, one block per
  tile and channel group, within the kernels' limits (at most ``NT_DX``
  threads, K2's segments at most ``TT_MM`` frames) and the card's shared
  memory, at the 8 stride-1 entry shapes of the coarse train step and of
  long-cycle phase D and at ragged ones (odd sizes and C, a one-pixel
  frame, a width split into column tiles, a long clip); K3's partial buffer
  has one row per block of a channel group.
* A torch model of the kernels' order (per output: dt, then dy, then dx,
  frames walked in order with a ring of three output frames) equals
  ``dw_conv3d_plain`` of g with the flipped taps exactly with f32 products
  and adds, and, with each term one fused multiply-add, K11's plain version
  (``dw_stencil3d_plain``): the card's exact oracle.  A copy with two loops
  swapped does not.  With the mask and the scale the model is held against
  the JAX Pallas kernel K3 (``_dx_act_raw``) interpreted.
* The wrappers take the plain versions on the CPU and count no launch; the
  bindings match the C declarations; the constants the plans mirror are the
  source's.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from coarse_fine_networks_tpu.ops.fold import (fold_pad, from_fold4, pad_vec,
                                               to_fold4)
from coarse_fine_networks_tpu.ops.pallas.dw_fold import (_dx_act_raw,
                                                         _prep_lane_weights)
from coarse_fine_networks_torch.ops import (dw_act, dw_conv, dw_mm_act,
                                            dw_mm_bn_train)
from coarse_fine_networks_torch.ops.dw_conv import (
    DX_PG, NT_DX, RMAX, RMIN, SMEM_MAX, TT_MM, plan_act_dx_s1, plan_mm_dx_s1,
    smem_dx_s1)
from coarse_fine_networks_torch.ops.dw_stencil import dw_stencil3d_plain

from _torch_port_util import t

torch.set_num_threads(2)

# (label, B, T, H, W, C_in, C_mid): the coarse train step's stride-1 entries
# (T=64 in layer1, T=17 after Grid Pool) and long-cycle phase D's (B8 T64
# 224², every stage at T=64), then ragged ones
PATH = [("coarse.layer1", 8, 64, 56, 56, 24, 54),
        ("coarse.layer2", 8, 17, 28, 28, 48, 108),
        ("coarse.layer3", 8, 17, 14, 14, 96, 216),
        ("coarse.layer4", 8, 17, 7, 7, 192, 432),
        ("D.layer1", 8, 64, 56, 56, 24, 54),
        ("D.layer2", 8, 64, 28, 28, 48, 108),
        ("D.layer3", 8, 64, 14, 14, 96, 216),
        ("D.layer4", 8, 64, 7, 7, 192, 432)]
RAGGED = [("7x6.c12", 1, 3, 7, 6, 8, 12), ("5x9.c13", 2, 5, 5, 9, 16, 13),
          ("one_pixel", 3, 1, 1, 1, 8, 1), ("wide", 1, 3, 4, 300, 8, 6),
          ("9x9.c7", 2, 9, 9, 9, 16, 7), ("long_clip", 1, 80, 5, 5, 8, 10)]
SHAPES = PATH + RAGGED
KINDS = [("act", 4), ("mm", 4), ("mm", 2)]


def _plan(kind, esz, b, tt, h, w, c_in, c):
    if kind == "act":
        return plan_act_dx_s1(b, tt, h, w, c)
    return plan_mm_dx_s1(b, tt, h, w, c_in, c, esz)


def _partitions(spans, n):
    """The distinct intervals ``spans`` cover ``[0, n)`` once each."""
    got = sorted(set(spans))
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(got, got[1:]))
    return len(got)


@pytest.mark.parametrize("kind,esz", KINDS,
                         ids=[f"{k}.{8 * e}" for k, e in KINDS])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_covers_every_output_once(shape, kind, esz):
    """One block per (item, channel group): each block's tile, clipped to
    dx, is a product of one interval per axis; the intervals of each axis
    partition it and every combination occurs once, so every element of dx
    is owned exactly once.  The split is within the kernels' limits and
    the card's shared memory, takes channel pairs first, and K3 writes one
    partial row per block of a group."""
    _, b, tt, h, w, c_in, c = shape
    p = _plan(kind, esz, b, tt, h, w, c_in, c)
    p2 = -(-c // 2)
    assert (p.b, p.t, p.h, p.w, p.c) == (b, tt, h, w, c)
    assert RMIN <= p.r <= RMAX and p.wb * p.pg <= NT_DX
    assert p.pg <= min(p2, DX_PG) and p.wb <= w and (p.wb >= 2 or w == 1)
    assert p.ipb == 1 and p.rows == p.items
    assert smem_dx_s1(p, c_in if kind == "mm" else c, esz,
                      kind == "mm") <= SMEM_MAX
    if kind == "act":  # one plan for both dtypes: bf16 needs less
        assert smem_dx_s1(p, c, 2, False) <= smem_dx_s1(p, c, 4, False)
    else:
        assert p.tt <= TT_MM
    tiles = [p.tile(item, g) for item in range(p.items)
             for g in range(p.n_pg)]
    assert len(set(tiles)) == len(tiles) == p.items * p.n_pg
    counts = [_partitions([tile[1 + a] for tile in tiles], n)
              for a, n in enumerate((tt, h, w, c))]
    assert len({tile[0] for tile in tiles}) == b
    assert len(tiles) == b * int(np.prod(counts))


def test_split_of_the_first_path_entry():
    """Layer1's entry (B8 T64 56² C54): all 27 channel pairs of a pixel in
    one group, 7 columns (189 threads, 6 warps), strips of 4 rows, the
    whole clip per block: 896 blocks; K2 the same with segments of 32."""
    p = plan_act_dx_s1(8, 64, 56, 56, 54)
    assert (p.r, p.wb, p.pg, p.n_pg, p.n_wt, p.tt) == (4, 7, 27, 1, 8, 64)
    assert p.items * p.n_pg == 896 and p.threads == 192
    q = plan_mm_dx_s1(8, 64, 56, 56, 24, 54, 2)
    assert (q.r, q.wb, q.pg, q.tt) == (4, 7, 27, 32)


# ---- the kernels' order ----------------------------------------------------------

def _order_model(g, w, fused, swap=False):
    """dx's da in the kernels' order: g frames walked in order, each adding
    tap dt = 2 - j to output frame ti - 1 + j (the register ring of three
    output frames; frames outside the clip add nothing), within a frame the
    staged rows (dy) in order, within a row the columns (dx) in order, with
    the flipped taps.  ``fused``: each term one fused multiply-add (the f64
    sum of the f32 sum and the exact product, rounded to f32); else an f32
    product, then an f32 add.  ``swap``: dx before dy (a wrong order)."""
    b, tn, h, wd, c = g.shape
    wf = torch.flip(w, (0, 1, 2))
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))  # zero rows and columns
    acc = torch.zeros((tn + 2, b, h, wd, c), dtype=torch.float32)
    for ti in range(tn):
        for j in range(3):
            to, dt = ti - 1 + j, 2 - j
            if not 0 <= to < tn:
                continue
            taps = [(dy, dx) for dy in range(3) for dx in range(3)]
            if swap:
                taps = [(dy, dx) for dx in range(3) for dy in range(3)]
            for dy, dx in taps:
                v = gp[:, ti, dy:dy + h, dx:dx + wd]
                k = wf[dt, dy, dx]
                if fused:
                    acc[to] = (acc[to].double() + v.double() * k.double()
                               ).float()
                else:
                    acc[to] = acc[to] + v * k
    return acc[:tn].permute(1, 0, 2, 3, 4)


def _gw(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    g = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, 3, c) / np.sqrt(27)).astype(np.float32)
    return t(g), t(w)


ORDER = [(2, 5, 7, 6, 13), (1, 4, 5, 9, 6), (1, 3, 4, 4, 54)]
ORDER_IDS = ["x".join(map(str, s)) for s in ORDER]


@pytest.mark.parametrize("shape", ORDER, ids=ORDER_IDS)
def test_order_is_the_plain_stride1_conv_on_the_flipped_taps(shape):
    """With f32 products and adds the kernels' order gives exactly what
    ``dw_conv3d_plain`` (the plain version of ``dw_conv_s1``: taps added in
    the order dt, dy, dx) gives on g with the flipped taps."""
    g, w = _gw(shape, seed=sum(shape))
    ref = dw_conv.dw_conv3d_plain(g, torch.flip(w, (0, 1, 2)), 1)
    assert torch.equal(_order_model(g, w, fused=False), ref)


@pytest.mark.parametrize("shape", ORDER, ids=ORDER_IDS)
def test_order_is_k11s_with_fused_adds(shape):
    """With each term one fused multiply-add (the kernels' fmaf) the order
    gives exactly what K11's order gives on g with the flipped taps: the
    card's oracle, ``dw_conv_s1`` in f32, equals K11 bit for bit."""
    g, w = _gw(shape, seed=sum(shape) + 1)
    ref = dw_stencil3d_plain(g, torch.flip(w, (0, 1, 2)))
    assert torch.equal(_order_model(g, w, fused=True), ref)


def test_a_swapped_order_is_caught():
    """The same model with the dy and dx loops swapped adds the taps in
    another order and differs from both oracles."""
    g, w = _gw(ORDER[0], seed=7)
    wf = torch.flip(w, (0, 1, 2))
    assert not torch.equal(_order_model(g, w, False, swap=True),
                           dw_conv.dw_conv3d_plain(g, wf, 1))
    assert not torch.equal(_order_model(g, w, True, swap=True),
                           dw_stencil3d_plain(g, wf))


def test_masked_order_matches_pallas_interpret():
    """K3's function in the kernels' order (the model's da, the relu mask
    with x·sc and + bi rounded apart, dx = dam·sc) against the JAX Pallas
    kernel K3 itself (``_dx_act_raw``), interpreted: f32 sums of 27 terms
    in another order."""
    shape = (1, 3, 8, 8, 12)
    c = shape[-1]
    rng = np.random.RandomState(3)
    g, w = _gw(shape, seed=11)
    x = t(rng.randn(*shape).astype(np.float32))
    sc = t((rng.rand(c) + 0.5).astype(np.float32))
    bi = t(rng.randn(c).astype(np.float32))
    dam = torch.where(x * sc + bi > 0, _order_model(g, w, fused=True), 0)
    got = dam * sc
    kj = jnp.flip(jnp.asarray(w.numpy()).reshape(3, 3, 3, 1, c), (0, 1, 2))
    p = fold_pad(c)
    dx, _ = _dx_act_raw(to_fold4(jnp.asarray(g.numpy())),
                        _prep_lane_weights(kj, c, p), True,
                        sc=pad_vec(jnp.asarray(sc.numpy()), c, p),
                        bi=pad_vec(jnp.asarray(bi.numpy()), c, p),
                        x2=to_fold4(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), np.asarray(from_fold4(dx, c)),
                               rtol=1e-5, atol=1e-5)


# ---- the wrappers, the bindings, the source ---------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_cpu_take_plain_and_count_nothing(dtype):
    """On a CPU tensor both wrappers return their plain version and launch
    nothing."""
    dw_act.reset_launches()
    dw_mm_bn_train.reset_launches()
    rng = np.random.RandomState(5)
    b, tt, h, w, c_in, c = 1, 3, 5, 6, 8, 10
    x = t(rng.randn(b, tt, h, w, c).astype(np.float32)).to(dtype)
    xi = t(rng.randn(b, tt, h, w, c_in).astype(np.float32)).to(dtype)
    w1 = t(rng.randn(c_in, c).astype(np.float32)).to(dtype)
    g = t(rng.randn(b, tt, h, w, c).astype(np.float32)).to(dtype)
    k = t(rng.randn(3, 3, 3, c).astype(np.float32)).to(dtype)
    sc = t((rng.rand(c) + 0.5).astype(np.float32))
    bi = t(rng.randn(c).astype(np.float32))
    for got, ref in zip(dw_act.dw_act_dx(g, x, k, sc, bi, 1),
                        dw_act.dw_act_dx_plain(g, x, k, sc, bi, 1)):
        assert torch.equal(got, ref)
    assert torch.equal(
        dw_mm_bn_train.dw_mm_dx_mask(g, xi, w1, k, sc, bi, 1),
        dw_mm_bn_train.dw_mm_dx_mask_plain(g, xi, w1, k, sc, bi, 1))
    assert not any(dw_act.LAUNCHES.values())
    assert not any(dw_mm_bn_train.LAUNCHES.values())


CHANGED = [(dw_mm_act.DX_S1_LIBRARY, n) for n in
           dw_mm_act.DX_S1_LIBRARY.functions] + [
    (dw_conv.LIBRARY_S2, "dw_mm_wgrad_s2_occupancy")]


@pytest.mark.parametrize("lib,name", CHANGED, ids=[n for _, n in CHANGED])
def test_changed_bindings_match_the_c_declarations(lib, name):
    """A pointer for each ``void*``, an int for each ``int``, in order."""
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % name,
                  lib.source.read_text())
    assert m, name
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in m.group(1).split(",")]
    assert lib.functions[name] == want


@pytest.mark.parametrize("name,value", [("NT_DX", NT_DX),
                                        ("SMEM_MAX", SMEM_MAX),
                                        ("NSTAGE", dw_conv.NSTAGE)])
def test_constants_match_the_source(name, value):
    """The limits the plans keep and the ring depth ``smem_dx_s1`` counts
    are the launcher's."""
    src = dw_mm_act.DX_S1_LIBRARY.source
    text = src.read_text() + (src.parent / "strip.cuh").read_text()
    m = re.search(r"constexpr int %s = (\d+);" % name, text)
    assert m and int(m.group(1)) == value


def test_partial_rows_have_no_stride1_kind_left():
    """K3's and K5's partial buffers have their plans' rows (the launchers
    refuse any other count), and so have the row-strip weight gradients'
    (K6 and K10: plain, act and mm, and the stride-(2, 2, 2) one; the
    launchers check that the block rows cover the items): no weight
    gradient or dx sizes its buffer by a kind any more
    (``dw_act_partial_rows`` went with ``dw_act_bwd.cu``), and the mm
    entry's module keeps no row-kind table."""
    src = dw_mm_act.DX_S1_LIBRARY.source.read_text()
    assert "rows != items" in src
    s2 = dw_conv.LIBRARY_S2.source.read_text()
    assert "rows != items" in s2
    for lib in dw_conv.LIBRARIES:
        assert "dw_act_partial_rows" not in lib.functions
        assert "dw_act_partial_rows" not in lib.source.read_text()
    assert not hasattr(dw_mm_act, "_ROWS_KIND")
    assert not hasattr(dw_mm_act, "_partials")
    cover = "(long long)rows * ipb < items"
    assert dw_conv.LIBRARY.source.read_text().count(cover) == 2
    assert s2.count(cover) == 3  # K10 plain and act; K10 mm; t2
