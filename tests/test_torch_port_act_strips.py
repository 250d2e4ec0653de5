"""K1 act (``dw_act_s1``) and K10 act (``dw_act_wgrad_s2``) on the row-strip
layout: the act modes of K1 plain (``csrc/dw_plain_s1.cu``, with
``plan_s1``) and K10 plain (``csrc/dw_plain_s2.cu``, with ``plan_s2``),
their x staged by ``cp.async`` and activated in place a frame ahead of the
stencil.  The kernels run only on the card, where ``chip_smoke.py`` holds
each against its exact oracle (K1 plain and K10 plain on the activated x,
with the same plan: a difference of 0, repeating bit for bit).  Here:

* the oracles' premises: the act forward's and the act stride-2 weight
  gradient's plain versions equal the plain versions on ``relu(x·sc + bi)``
  rounded to x's dtype, exactly, in f32 and bf16; and the plain versions on
  the activated x match the JAX Pallas kernels in act mode, interpreted
  (``dw_fold4_act`` at 1e-5; ``_wgrad_s2_raw`` at 1e-4, f32 sums over every
  position in another order), with every bi > 0 (a padding of relu(bi)
  would show);
* the torch model of the act ring (``act_ring_reads``) at a stride-2 tile
  (2R+1 rows, 2WB+1 columns): the zero padding of a, an in-frame NaN kept;
* the wrappers pass the arguments the C declarations take (the kernel
  path, traced on meta tensors) with the plans of K1 and K10 plain, whose
  act rings fit the card's shared memory at the path's shapes, and with
  K4 act's and K6 mm's own plans (``plan_act_s2_fwd``,
  ``plan_mm_wgrad_s1``).

That each has one home, ``dw_plain_s1.cu`` and ``dw_plain_s2.cu``, is
``test_torch_port_plain_s1.py::test_stride1_entries_left_the_entry_sources``'s,
and that the bindings match the C declarations its
``test_bindings_match_the_c_declarations``'s.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from coarse_fine_networks_tpu.ops.fold import (fold_pad, from_fold4, pad_vec,
                                               to_fold4)
from coarse_fine_networks_tpu.ops.pallas.dw_fold import (_wgrad_s2_raw,
                                                         dw_fold4_act)
from coarse_fine_networks_torch.ops import dw_act, dw_conv, dw_mm_act
from coarse_fine_networks_torch.ops.dw_act import (_activate, dw_act_wgrad,
                                                   dw_act_wgrad_plain,
                                                   dw_bnrelu_conv3d,
                                                   dw_bnrelu_conv3d_plain)
from coarse_fine_networks_torch.ops.dw_conv import (SMEM_MAX,
                                                    dw_conv3d_plain,
                                                    dw_conv_wgrad_plain,
                                                    plan_act_s2_fwd,
                                                    plan_mm_wgrad_s1,
                                                    plan_s1, plan_s2,
                                                    smem_s2)
from coarse_fine_networks_torch.ops.dw_mm_act import dw_mm_wgrad

from _torch_port_util import t
from test_torch_port_act_bwd import _phase_sum, act_ring_reads

torch.set_num_threads(2)

SHAPES = [(2, 4, 9, 7, 13), (1, 5, 8, 8, 54), (1, 3, 1, 1, 6)]
# x of the act kernels at the path's entries: (B, T, H, C) of the coarse
# train step (T=64 in layer1, 17 after Grid Pool) and of long-cycle phase D
PATH = [(8, 64, 56, 54), (8, 17, 28, 108), (8, 17, 14, 216), (8, 17, 7, 432),
        (8, 64, 28, 108), (8, 64, 14, 216), (8, 64, 7, 432)]
PATH_S2 = [(8, 64, 112, 54), (8, 17, 56, 108), (8, 17, 28, 216),
           (8, 17, 14, 432), (8, 64, 56, 108), (8, 64, 28, 216),
           (8, 64, 14, 432)]


def _inputs(shape, seed, dtype=torch.float32, stride=1, bi_positive=False):
    """x, taps, sc (either sign), bi and g of y's shape."""
    rng = np.random.RandomState(seed)
    b, tt, h, w, c = shape
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, 3, c) / np.sqrt(27)).astype(np.float32)
    sc = rng.randn(c).astype(np.float32)
    bi = rng.randn(c).astype(np.float32)
    if bi_positive:
        bi = np.abs(bi) + 0.25
    g = rng.randn(b, tt, (h - 1) // stride + 1, (w - 1) // stride + 1,
                  c).astype(np.float32)
    return (t(x).to(dtype), t(k).to(dtype), t(sc), t(bi), t(g).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s))
                                               for s in SHAPES])
def test_act_forward_is_plain_stencil_of_the_activation(shape, dtype):
    """The premise of K1 act's oracle: its plain version is K1 plain's on
    ``relu(x·sc + bi)`` rounded to x's dtype, exactly."""
    x, k, sc, bi, _ = _inputs(shape, seed=sum(shape), dtype=dtype)
    got = dw_bnrelu_conv3d_plain(x, k, sc, bi, 1)
    want = dw_conv3d_plain(_activate(x, sc, bi), k, 1)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s))
                                               for s in SHAPES])
def test_act_wgrad_s2_is_plain_wgrad_of_the_activation(shape, dtype):
    """The premise of K10 act's oracle: its plain version is K10 plain's on
    the activated x, exactly."""
    x, _, sc, bi, g = _inputs(shape, seed=sum(shape) + 1, dtype=dtype,
                              stride=2)
    got = dw_act_wgrad_plain(x, g, sc, bi, 2)
    want = dw_conv_wgrad_plain(_activate(x, sc, bi), g, 2)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_plain_stencil_of_the_activation_matches_pallas():
    """K1 plain's version on the activated x against the JAX Pallas kernel
    K1 in act mode (``dw_fold4_act`` at stride 1), interpreted, at 1e-5."""
    c = 12
    x, k, sc, bi, _ = _inputs((2, 4, 16, 8, c), seed=40, bi_positive=True)
    p = fold_pad(c)
    y = dw_fold4_act(to_fold4(jnp.asarray(x.numpy())),
                     jnp.asarray(k.numpy()).reshape(3, 3, 3, 1, c),
                     pad_vec(jnp.asarray(sc.numpy()), c, p),
                     pad_vec(jnp.asarray(bi.numpy()), c, p), c, 1, True)
    got = dw_conv3d_plain(_activate(x, sc, bi), k, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(from_fold4(y, c)),
                               rtol=1e-5, atol=1e-5)


def test_plain_wgrad_s2_of_the_activation_matches_pallas():
    """K10 plain's version on the activated x against the JAX Pallas kernel
    K10 in act mode (``_wgrad_s2_raw``, the weight gradient
    ``dw_fold4_act``'s VJP takes at stride 2), interpreted, at 1e-4."""
    c = 12
    x, _, sc, bi, g = _inputs((2, 4, 16, 8, c), seed=41, stride=2,
                              bi_positive=True)
    p = fold_pad(c)
    dk = _wgrad_s2_raw(to_fold4(jnp.asarray(x.numpy())),
                       to_fold4(jnp.asarray(g.numpy())), True,
                       sc=pad_vec(jnp.asarray(sc.numpy()), c, p),
                       bi=pad_vec(jnp.asarray(bi.numpy()), c, p))
    got = dw_conv_wgrad_plain(_activate(x, sc, bi), g, 2)
    np.testing.assert_allclose(got.numpy(), _phase_sum(dk, c), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_ring_at_a_stride2_tile(dtype):
    """K10 act stages the 2R+1 input rows 2h0-1 .. 2h0+2R-1 and the 2WB+1
    columns 2w0-1 .. 2w0+2WB-1 of an output tile (stored de-interleaved, a
    permutation of the columns): the model of the act ring gives the
    stencil the zero-padded activation there, an in-frame NaN kept."""
    rng = np.random.RandomState(6)
    x = t(rng.randn(5, 9, 11, 4).astype(np.float32)).to(dtype)
    x[1, 8, 10, 2] = float("nan")
    sc = t(rng.randn(4).astype(np.float32))
    bi = t(np.abs(rng.randn(4)).astype(np.float32) + 0.25)
    want = F.pad(_activate(x[None], sc, bi)[0].float(),
                 (0, 0, 1, 1, 1, 1, 1, 1)).to(dtype)
    for h0, r, w0, wb in ((0, 2, 0, 3), (3, 2, 4, 2)):  # output tiles
        rows = list(range(2 * h0 - 1, 2 * h0 + 2 * r))
        cols = list(range(2 * w0 - 1, 2 * w0 + 2 * wb))
        reads = act_ring_reads(x, sc, bi, rows, cols, 0, 5)
        assert len(reads) == 5
        for f, got in enumerate(reads):
            ref = torch.zeros_like(got)
            hs = [q for q, h in enumerate(rows) if h <= 9]
            ws = [q for q, w in enumerate(cols) if w <= 11]
            ref[np.ix_(hs, ws)] = want[f + 1][[rows[q] + 1 for q in hs]][
                :, [cols[q] + 1 for q in ws]]
            assert torch.equal(torch.isnan(got), torch.isnan(ref))
            fin = ~torch.isnan(ref)
            assert torch.equal(got[fin], ref[fin])
    assert torch.isnan(reads[1]).any()


def _traced(monkeypatch, fn, *args, mod=dw_act):
    """``fn``'s kernel path on meta tensors: the library, the entry and the
    arguments it would pass (``_launch`` appends the dtype flag and the
    stream); ``mod`` is the wrapper's module."""
    calls = []
    monkeypatch.setattr(mod, "_check", lambda *a, **k: None)
    if mod is dw_mm_act:
        monkeypatch.setattr(mod, "_check_kernel_input", lambda x: None)
    monkeypatch.setattr(mod, "_launch",
                        lambda counts, lib, name, x, *a: calls.append(
                            (lib, name, a)))
    fn(*(a.to("meta") for a in args))
    (lib, name, a), = calls
    return lib, name, a


def test_wrappers_pass_the_declared_arguments_and_plans(monkeypatch):
    shape = (2, 5, 9, 7, 13)
    x, k, sc, bi, g1 = _inputs(shape, seed=7)
    _, _, _, _, g2 = _inputs(shape, seed=7, stride=2)
    lib, name, a = _traced(monkeypatch, lambda *v: dw_bnrelu_conv3d(*v, 1),
                           x, k, sc, bi)
    p = plan_s1(*shape)
    assert (lib, name) == (dw_conv.LIBRARY, "dw_act_s1")
    assert len(a) + 2 == len(lib.functions[name])
    assert list(a[5:]) == [*shape, p.r, p.wb, p.pg, p.tt]
    lib, name, a = _traced(monkeypatch, lambda *v: dw_act_wgrad(*v, 2),
                           x, g2, sc, bi)
    p = plan_s2(*shape)
    assert (lib, name) == (dw_conv.LIBRARY_S2, "dw_act_wgrad_s2")
    assert len(a) + 2 == len(lib.functions[name])
    assert list(a[5:]) == [*shape, p.r, p.wb, p.pg, p.tt, p.ipb, p.rows]
    # K4 act: K4 plain's source, with a plan of its own ring
    lib, name, a = _traced(monkeypatch, lambda *v: dw_bnrelu_conv3d(*v, 2),
                           x, k, sc, bi)
    p = plan_act_s2_fwd(*shape)
    assert (lib, name) == (dw_conv.LIBRARY_S2, "dw_act_s2")
    assert len(a) + 2 == len(lib.functions[name])
    assert list(a[5:]) == [*shape, p.r, p.wb, p.pg, p.tt]
    # K6 mm: K6 plain's source, x is conv1's input (C_in 8), g has C_mid
    b, t, h, w, c = shape
    xi = torch.zeros((b, t, h, w, 8))
    w1 = torch.zeros((8, c))
    lib, name, a = _traced(monkeypatch, lambda *v: dw_mm_wgrad(*v, 1),
                           xi, w1, g1, sc, bi, mod=dw_mm_act)
    p = plan_mm_wgrad_s1(b, t, h, w, 8, c, 4)  # f32: 4-byte elements
    assert list(a[6:]) == [b, t, h, w, 8, c, p.r, p.wb, p.pg, p.tt, p.ipb,
                           p.rows]
    assert (lib, name) == (dw_conv.LIBRARY, "dw_mm_wgrad_s1")
    assert len(a) + 2 == len(lib.functions[name])


@pytest.mark.parametrize("esz", [2, 4])
def test_act_rings_fit_at_the_path_shapes(esz):
    """One frame more than the plain rings (the weight gradients reuse
    theirs for the column sums, which may be larger), within a block's
    shared memory and, in bf16, two blocks per SM (228 KB): K1 act and K6
    act at ``plan_s1``, K10 act at ``plan_s2``."""
    for b, tt, h, c in PATH:
        p = plan_s1(b, tt, h, h, c)
        for wgrad in (False, True):
            act = p.smem(esz, wgrad, True)
            assert p.smem(esz, wgrad) <= act <= SMEM_MAX
            assert esz == 4 or 2 * act <= 228 * 1024
    for b, tt, h, c in PATH_S2:
        p = plan_s2(b, tt, h, h, c)
        act = smem_s2(p, esz, True)
        assert smem_s2(p, esz) <= act <= SMEM_MAX
        assert esz == 4 or 2 * act <= 228 * 1024
