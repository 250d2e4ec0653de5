"""A NaN relu input stays NaN in the port, as in the JAX reference.

The JAX package's act and mm prologues (``_act_tile``, ``_mm_act_tile``,
``coarse_fine_networks_tpu/ops/pallas/dw_fold.py``) and its XLA path use
``jnp.maximum(v, 0)``, which keeps a NaN; so do the port's eager twins
(``torch.relu``).  The kernels' relu is ``relu()`` of ``csrc/common.cuh``,
``v < 0 ? 0 : v``, which keeps it too (``fmaxf`` returned 0).  Here, on the
CPU:

* with one NaN in x and one NaN channel of sc, the twins of the act forward
  (K1/K4 act), of its weight gradient (K6/K10 act) and of the eval entry's
  forward (K1/K4 mm) put NaN at exactly the positions where the JAX Pallas
  kernels, interpreted as the JAX package's tests run them (``dw_fold4_act``,
  the act weight gradients its VJP calls, ``dw_fold4_mm_act``), put it, and
  their finite elements agree at 1e-5 (forward) and 1e-4 (weight gradient:
  f32 sums over every position in another order).  The NaN lies inside the
  frame, on its first or last frame, on its first or last row or on its
  last column (the edges where the row-strip weight gradients' ring holds
  the zero of a g element outside the item, fault 3.4).  The mm entry's x
  is conv1's input: the JAX kernel's block-diagonal fold4 product also
  spreads a NaN of x to the three other rows of its fold (NaN·0 in the zero
  blocks), a layout artifact the port does not copy, so there the JAX
  positions are the twin's on x with the NaN copied to those rows (the eval
  forward, K1/K4 mm, and the mm weight gradients, K6/K10 mm);
* the kernels' relu, modelled in torch, equals ``torch.relu`` bit for bit,
  NaN and -0 included;
* no relu of ``csrc/`` is an ``fmaxf`` with 0.

The kernels run only on the card, where ``chip_smoke.py``'s ``nan`` phase
holds every relu kernel and every masked dx against its twin with the same
NaNs at the path's entry shapes."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coarse_fine_networks_tpu.ops.fold import (FOLD, fold_pad,
                                               fold_pointwise_kernel,
                                               from_fold4, pad_vec, to_fold4)
from coarse_fine_networks_tpu.ops.pallas.dw_fold import (
    _dw_fold4_wgrad_raw, _wgrad_s2_raw, dw_fold4_act, dw_fold4_mm_act)
from coarse_fine_networks_torch.ops import dw_conv
from coarse_fine_networks_torch.ops.dw_act import (dw_act_wgrad_plain,
                                                   dw_bnrelu_conv3d_plain)
from coarse_fine_networks_torch.ops.dw_mm_act import (
    dw_mm_bnrelu_conv3d_plain, dw_mm_wgrad_plain)

from _torch_port_util import t

torch.set_num_threads(2)

C = 12
SHAPE = (1, 4, 16, 16, C)
# (t, h, w) of x's NaN: inside the frame, on its first frame, on its first
# row, on its last frame, its last row and its last column
WHERE = {"inside": (2, 7, 9), "first_frame": (0, 7, 9), "first_row": (2, 0, 9),
         "last_frame": (3, 7, 9), "last_row": (2, 15, 9),
         "last_column": (2, 7, 15)}


def _lanes(v, c):
    return pad_vec(jnp.asarray(v), c, fold_pad(c))


def _phase_sum(v, c):
    """(…, 4P) per-lane sums → (…, C) per-channel sums."""
    v = np.asarray(v)
    return v.reshape(v.shape[:-1] + (FOLD, v.shape[-1] // FOLD)).sum(-2)[
        ..., :c]


def _inputs(where, stride, seed, c_in=None):
    """x (C channels, or ``c_in``: the mm entry's input) with a NaN at
    channel 0 of ``WHERE[where]``, taps, sc with channel 1 NaN, bi (half
    negative) and g of y's shape."""
    rng = np.random.RandomState(seed)
    b, tt, h, w, c = SHAPE
    x = rng.randn(b, tt, h, w, c_in or c).astype(np.float32)
    x[(0,) + WHERE[where] + (0,)] = np.nan
    k = (rng.randn(3, 3, 3, c) / np.sqrt(27)).astype(np.float32)
    sc = (rng.rand(c) + 0.5).astype(np.float32)
    sc[1] = np.nan
    bi = rng.randn(c).astype(np.float32)
    bi[: c // 2] = -np.abs(bi[: c // 2]) - 0.5
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = rng.randn(b, tt, ho, wo, c).astype(np.float32)
    return x, k, sc, bi, g


def _same_nans(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    nan = np.isnan(ref)
    assert nan.any()
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=tol, atol=tol)


@pytest.mark.parametrize("where", list(WHERE))
@pytest.mark.parametrize("stride", [1, 2])
def test_act_forward_nans_match_pallas(stride, where):
    x, k, sc, bi, _ = _inputs(where, stride, seed=stride)
    y = dw_fold4_act(to_fold4(jnp.asarray(x)),
                     jnp.asarray(k).reshape(3, 3, 3, 1, C), _lanes(sc, C),
                     _lanes(bi, C), C, stride, True)
    got = dw_bnrelu_conv3d_plain(t(x), t(k), t(sc), t(bi), stride)
    _same_nans(got.numpy(), from_fold4(y, C), 1e-5)


@pytest.mark.parametrize("where", list(WHERE))
@pytest.mark.parametrize("stride", [1, 2])
def test_act_wgrad_nans_match_pallas(stride, where):
    """The weight gradient ``dw_fold4_act``'s VJP takes (``_dw_act_bwd``:
    K6 act at stride 1, K10 act at stride 2): the NaN channel's 27 taps, and
    those of the NaN x's channel whose output positions exist (a NaN on the
    first frame or row has no tap dt = 2 or dy = 2)."""
    x, _, sc, bi, g = _inputs(where, stride, seed=10 + stride)
    raw = _dw_fold4_wgrad_raw if stride == 1 else _wgrad_s2_raw
    dk = raw(to_fold4(jnp.asarray(x)), to_fold4(jnp.asarray(g)), True,
             sc=_lanes(sc, C), bi=_lanes(bi, C))
    got = dw_act_wgrad_plain(t(x), t(g), t(sc), t(bi), stride)
    _same_nans(got.numpy(), _phase_sum(dk, C), 1e-4)
    assert np.isnan(got.numpy()[:, 1]).all()
    if where != "inside":
        assert not np.isnan(got.numpy()[:, 0]).all()


@pytest.mark.parametrize("stride", [1, 2])
def test_mm_forward_nans_match_pallas(stride):
    c_in = 8
    x, k, sc, bi, _ = _inputs("inside", stride, seed=20 + stride, c_in=c_in)
    w1 = (np.random.RandomState(3).randn(c_in, C) / 3).astype(np.float32)
    y = dw_fold4_mm_act(
        to_fold4(jnp.asarray(x)),
        fold_pointwise_kernel(jnp.asarray(w1).reshape(1, 1, 1, c_in, C),
                              c_in, C),
        jnp.asarray(k).reshape(3, 3, 3, 1, C), _lanes(sc, C), _lanes(bi, C),
        C, stride, True)
    # the fold4 product's NaN·0: the NaN row's three fold siblings
    x_fold = _fold_siblings(x, "inside")
    _same_nans(dw_mm_bnrelu_conv3d_plain(t(x_fold), t(w1), t(k), t(sc),
                                         t(bi), stride).numpy(),
               from_fold4(y, C), 1e-5)
    got = dw_mm_bnrelu_conv3d_plain(t(x), t(w1), t(k), t(sc), t(bi), stride)
    assert torch.isnan(got).sum() < np.isnan(np.asarray(y)).sum()


def _fold_siblings(x, where):
    """x with its NaN copied to the three other rows of its fold: the JAX
    fold4 product's NaN·0 in the zero blocks."""
    tt, h, w = WHERE[where]
    x = x.copy()
    x[0, tt, h // FOLD * FOLD:(h // FOLD + 1) * FOLD, w, :] = np.nan
    return x


@pytest.mark.parametrize("where", list(WHERE))
@pytest.mark.parametrize("stride", [1, 2])
def test_mm_wgrad_nans_match_pallas(stride, where):
    """The mm weight gradients (K6 mm at stride 1, K10 mm at stride 2, the
    backward of the train composite and of the eval entry): the twin on x
    with the JAX fold4 NaN spread puts NaN where the interpreted JAX kernel
    does, and its finite taps agree at 1e-4; on x itself its NaN taps are
    among those (the spread adds NaN, it takes none away)."""
    c_in = 8
    x, _, sc, bi, g = _inputs(where, stride, seed=30 + stride, c_in=c_in)
    w1 = (np.random.RandomState(4).randn(c_in, C) / 3).astype(np.float32)
    raw = _dw_fold4_wgrad_raw if stride == 1 else _wgrad_s2_raw
    dk = raw(to_fold4(jnp.asarray(x)), to_fold4(jnp.asarray(g)), True,
             sc=_lanes(sc, C), bi=_lanes(bi, C),
             wmm=fold_pointwise_kernel(
                 jnp.asarray(w1).reshape(1, 1, 1, c_in, C), c_in, C))
    ref = _phase_sum(dk, C)
    got = dw_mm_wgrad_plain(t(_fold_siblings(x, where)), t(w1), t(g), t(sc),
                            t(bi), stride)
    _same_nans(got.numpy(), ref, 1e-4)
    own = dw_mm_wgrad_plain(t(x), t(w1), t(g), t(sc), t(bi), stride).numpy()
    assert np.isnan(ref[np.isnan(own)]).all()
    assert np.isnan(own[:, 1]).all()


def test_kernel_relu_is_torch_relu():
    """``relu()`` of ``csrc/common.cuh`` (``v < 0 ? 0 : v``) on NaN, ±0,
    ±inf and ordinary values equals ``torch.relu`` bit for bit, and keeps
    NaN as ``jnp.maximum(v, 0)`` does (which differs only in the sign of a
    zero, which moves no sum)."""
    src = (dw_conv.LIBRARY.source.parent / "common.cuh").read_text()
    assert re.search(r"float relu\(float v\) \{ return v < 0\.f \? 0\.f : v; \}",
                     src)
    v = torch.tensor([float("nan"), -0.0, 0.0, float("inf"), -float("inf"),
                      -1.5, 2.25, -1e-38, 1e-38])
    model = torch.where(v < 0, torch.zeros_like(v), v)
    assert torch.equal(model.view(torch.int32), torch.relu(v).view(torch.int32))
    ref = np.maximum(np.asarray(jnp.asarray(v.numpy())), 0)
    assert np.isnan(ref[0]) and torch.isnan(model[0])
    np.testing.assert_array_equal(model.numpy()[1:], ref[1:])


def test_no_relu_in_the_sources_drops_nan():
    """No kernel source computes a relu as ``fmaxf`` (or ``fmax``) of a
    value and 0, which maps NaN to 0."""
    csrc = dw_conv.LIBRARY.source.parent
    pat = re.compile(r"\bfmaxf?\s*\(\s*(?:[^,()]|\([^()]*\))*,\s*"
                     r"0(?:\.0*)?f?\s*\)|\bfmaxf?\s*\(\s*0(?:\.0*)?f?\s*,")
    files = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    assert len(files) >= 8  # the five sources and the three headers
    for f in files:
        code = "\n".join(line.split("//")[0]
                         for line in f.read_text().splitlines())
        assert not pat.search(code), f"{f.name}: {pat.search(code).group(0)}"
