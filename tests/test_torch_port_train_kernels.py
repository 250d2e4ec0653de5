"""The port's train-mode bottleneck entry (``ops/dw_act.py``): the plain
versions of its six kernel entries, and the autograd Function built on them.

The plain versions are held against the JAX Pallas kernels themselves, run
in interpret mode on the CPU as ``tests/test_dw_fold.py`` runs them: the
``act`` modes of K1/K4 (forward), K3/K5 (dx with the relu mask and the
``(dsc, dbi)`` partials) and the ``act`` modes of K6/K10 (weight gradient);
the Function's four gradients against ``jax.vjp`` of ``dw_fold4_act``; and
odd sizes, which the fold4 kernels do not take, against a direct XLA
reference and ``jax.grad``.  The CUDA kernels only run on the card:
``chip_smoke.py`` holds them against these plain versions there.

All f32.  Tolerance 1e-4 absolute and relative: f32 sums of 27 taps (and of
up to 2·16·16·4 positions for the reductions) in different orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from coarse_fine_networks_tpu.ops.fold import (fold_pad, from_fold4, pad_vec,
                                               to_fold4)
from coarse_fine_networks_tpu.ops.pallas.dw_fold import (
    FOLD, _dw_fold4_wgrad_raw, _dx_act_raw, _dx_s2_act_raw,
    _prep_lane_weights, _wgrad_s2_raw, dw_fold4_act, fold_dw_bnrelu_conv3d)
from coarse_fine_networks_torch.ops import (dw_act, dw_conv, dw_mm_act,
                                            dw_mm_bn_train)
from coarse_fine_networks_torch.ops.dw_act import (
    dw_act_dx, dw_act_dx_plain, dw_act_wgrad, dw_act_wgrad_plain,
    dw_bnrelu_conv3d, dw_bnrelu_conv3d_plain, dw_bnrelu_conv3d_train)

from _torch_port_util import t

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
C = 54  # layer1's C_mid: no multiple of 8 or 32


def _inputs(shape, seed, stride=1):
    """x, taps, sc, bi and a cotangent g of y's shape; half the channels
    get a negative bi, so relu(bi) != 0 and the zero frame matters."""
    rng = np.random.RandomState(seed)
    b, tt, h, w, c = shape
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, 3, c) / np.sqrt(27)).astype(np.float32)
    sc = (rng.rand(c) + 0.5).astype(np.float32)
    bi = rng.randn(c).astype(np.float32)
    bi[: c // 2] = -np.abs(bi[: c // 2]) - 0.5
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = rng.randn(b, tt, ho, wo, c).astype(np.float32)
    return x, k, sc, bi, g


def _lanes(v, c):
    return pad_vec(jnp.asarray(v), c, fold_pad(c))


def _phase_sum(v, c):
    """(…, 4P) per-lane sums → (…, C) per-channel sums."""
    v = np.asarray(v)
    return v.reshape(v.shape[:-1] + (FOLD, v.shape[-1] // FOLD)).sum(-2)[
        ..., :c]


SHAPE = (2, 4, 16, 16, C)


@pytest.mark.parametrize("stride", [1, 2])
def test_forward_plain_matches_pallas(stride):
    x, k, sc, bi, _ = _inputs(SHAPE, seed=stride)
    y = fold_dw_bnrelu_conv3d(
        to_fold4(jnp.asarray(x)), jnp.asarray(k).reshape(3, 3, 3, 1, C),
        _lanes(sc, C), _lanes(bi, C), C, stride, impl="interpret")
    ref = np.asarray(from_fold4(y, C))
    got = dw_bnrelu_conv3d_plain(t(x), t(k), t(sc), t(bi), stride)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_dx_plain_matches_pallas(stride):
    """K3 (stride 1: the stencil of g with flipped taps) and K5 (stride 2:
    the half-resolution gather), each with the in-kernel relu mask, output
    ``dam·sc`` and the per-batch ``(Σ dam·x, Σ dam)`` partials."""
    x, k, sc, bi, g = _inputs(SHAPE, seed=10 + stride, stride=stride)
    p = fold_pad(C)
    kj = jnp.asarray(k).reshape(3, 3, 3, 1, C)
    if stride == 1:
        raw, kj = _dx_act_raw, jnp.flip(kj, axis=(0, 1, 2))
    else:
        raw = _dx_s2_act_raw
    dx, red = raw(to_fold4(jnp.asarray(g)), _prep_lane_weights(kj, C, p),
                  True, sc=_lanes(sc, C), bi=_lanes(bi, C),
                  x2=to_fold4(jnp.asarray(x)))
    got_dx, got_red = dw_act_dx_plain(t(g), t(x), t(k), t(sc), t(bi), stride)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(from_fold4(dx, C)),
                               **TOL)
    np.testing.assert_allclose(got_red.numpy(),
                               _phase_sum(np.asarray(red).sum(0), C), **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_wgrad_plain_matches_pallas(stride):
    x, _, sc, bi, g = _inputs(SHAPE, seed=20 + stride, stride=stride)
    raw = _dw_fold4_wgrad_raw if stride == 1 else _wgrad_s2_raw
    dk = raw(to_fold4(jnp.asarray(x)), to_fold4(jnp.asarray(g)), True,
             sc=_lanes(sc, C), bi=_lanes(bi, C))
    got = dw_act_wgrad_plain(t(x), t(g), t(sc), t(bi), stride)
    assert got.shape == (27, C)
    np.testing.assert_allclose(got.numpy(), _phase_sum(dk, C), **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_function_matches_jax_vjp(stride):
    """``(dx, dw, dsc, dbi)`` of the autograd Function against ``jax.vjp``
    of ``dw_fold4_act`` (the Pallas kernels under the interpreter)."""
    x, k, sc, bi, g = _inputs(SHAPE, seed=30 + stride, stride=stride)

    def f(x, k, sc, bi):
        return from_fold4(dw_fold4_act(to_fold4(x), k, sc, bi, C, stride,
                                       True), C)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(k).reshape(3, 3, 3, 1, C),
                     _lanes(sc, C), _lanes(bi, C))
    gx, gk, gsc, gbi = vjp(jnp.asarray(g))

    xt, kt, sct, bit = (t(a).requires_grad_() for a in (x, k, sc, bi))
    yt = dw_bnrelu_conv3d_train(xt, kt, sct, bit, stride)
    yt.backward(t(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **TOL)
    for got, ref in ((xt.grad, gx), (kt.grad, np.asarray(gk).reshape(27, C)),
                     (sct.grad, _phase_sum(gsc, C)),
                     (bit.grad, _phase_sum(gbi, C))):
        np.testing.assert_allclose(got.reshape(np.shape(ref)).numpy(),
                                   np.asarray(ref), **TOL)


def _xla_loss(x, k, sc, bi, g, stride):
    a = jnp.maximum(x * sc + bi, 0.0)
    y = lax.conv_general_dilated(
        a, k.reshape(3, 3, 3, 1, -1), (1, stride, stride), [(1, 1)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        feature_group_count=a.shape[-1], precision=lax.Precision.HIGHEST)
    return jnp.sum(y * g), y


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(7, 7), (5, 9)])
def test_odd_sizes_against_xla_and_jax_grad(hw, stride):
    """Odd H, W (a 25×25 input reaches layer3.0 at odd size): forward and
    all four gradients against an XLA conv and ``jax.grad``."""
    x, k, sc, bi, g = _inputs((2, 3) + hw + (20,), seed=40, stride=stride)
    args = [jnp.asarray(a) for a in (x, k, sc, bi)]
    (_, y), grads = jax.value_and_grad(
        _xla_loss, argnums=(0, 1, 2, 3), has_aux=True)(
            *args, jnp.asarray(g), stride)
    xt, kt, sct, bit = (t(a).requires_grad_() for a in (x, k, sc, bi))
    yt = dw_bnrelu_conv3d_train(xt, kt, sct, bit, stride)
    assert yt.shape == y.shape
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **TOL)
    torch.sum(yt * t(g)).backward()
    for got, ref in zip((xt.grad, kt.grad, sct.grad, bit.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_wrappers_cpu_take_plain_and_count_nothing():
    x, k, sc, bi, g1 = _inputs((1, 3, 6, 6, 12), seed=50)
    _, _, _, _, g2 = _inputs((1, 3, 6, 6, 12), seed=50, stride=2)
    dw_act.reset_launches()
    for s, g in ((1, g1), (2, g2)):
        a = (t(x), t(k), t(sc), t(bi), s)
        assert torch.equal(dw_bnrelu_conv3d(*a), dw_bnrelu_conv3d_plain(*a))
        d = (t(g), t(x), t(k), t(sc), t(bi), s)
        for got, ref in zip(dw_act_dx(*d), dw_act_dx_plain(*d)):
            assert torch.equal(got, ref)
        w = (t(x), t(g), t(sc), t(bi), s)
        assert torch.equal(dw_act_wgrad(*w), dw_act_wgrad_plain(*w))
    assert set(dw_act.LAUNCHES) == {
        "dw_act_s1", "dw_act_s2", "dw_act_dx_s1", "dw_act_dx_s2",
        "dw_act_wgrad_s1", "dw_act_wgrad_s2"}
    assert not any(dw_act.LAUNCHES.values())


def test_bf16_rounds_activation_and_keeps_dtypes():
    """bf16: the forward and the weight gradient use the activation rounded
    to bf16; y and dx are bf16, the weight gradient and the (dsc, dbi) sums
    f32, and the Function's weight gradient comes back in the taps' dtype."""
    x, k, sc, bi, g = _inputs((1, 2, 4, 4, 8), seed=60)
    xb, kb, gb = (t(a).bfloat16() for a in (x, k, g))
    a = torch.relu(xb.float() * t(sc) + t(bi)).bfloat16()
    one, zero = torch.ones(8), torch.zeros(8)
    y = dw_bnrelu_conv3d(xb, kb, t(sc), t(bi), 1)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, dw_bnrelu_conv3d(a, kb, one, zero, 1))
    dk = dw_act_wgrad(xb, gb, t(sc), t(bi), 1)
    assert dk.dtype == torch.float32
    assert torch.equal(dk, dw_act_wgrad(a, gb, one, zero, 1))
    dx, red = dw_act_dx(gb, xb, kb, t(sc), t(bi), 1)
    assert dx.dtype == torch.bfloat16 and red.dtype == torch.float32
    xr, kr = xb.clone().requires_grad_(), kb.clone().requires_grad_()
    dw_bnrelu_conv3d_train(xr, kr, t(sc), t(bi), 1).backward(gb)
    assert xr.grad.dtype == kr.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["dtype", "w_dw", "sc", "stride", "g",
                                 "noncontig", "device"])
def test_wrappers_reject(bad):
    x, k, sc, bi, g = (t(a) for a in _inputs((1, 2, 4, 4, 8), seed=70))
    stride = 1
    if bad == "dtype":
        x = x.double()
    elif bad == "w_dw":
        k = k.reshape(27, 8)
    elif bad == "sc":
        sc = sc[:4]
    elif bad == "stride":
        stride = 3
    elif bad == "g":
        g = g[:, :, :2].contiguous()
    elif bad == "noncontig":
        x = x.transpose(2, 3)
    else:  # no kernel and no plain version off the CPU and the card
        x, k, sc, bi, g = (a.to("meta") for a in (x, k, sc, bi, g))
    with pytest.raises((ValueError, TypeError)):
        if bad == "g":
            dw_act_dx(g, x, k, sc, bi, stride)
        else:
            dw_bnrelu_conv3d(x, k, sc, bi, stride)
    if bad != "w_dw":
        with pytest.raises((ValueError, TypeError)):
            dw_act_wgrad(x, g, sc, bi, stride)


def test_kernel_sources_ship_every_entry():
    # the act route's entries, and the mm route's of the train composite,
    # each bound and in its source: the stride-1 dx (K3, K2) in
    # dw_dx_s1.cu, K1 act, K6 act and K6 mm in dw_plain_s1.cu, K4 act, K4
    # mm, K5, K9, K10 act and K10 mm in dw_plain_s2.cu, the stride-1 mm
    # forward in dw_mm_act.cu
    for name in (*dw_act.LAUNCHES, *dw_mm_act.LAUNCHES,
                 *dw_mm_bn_train.LAUNCHES):
        lib = (dw_mm_act.DX_S1_LIBRARY if name in ("dw_act_dx_s1",
                                                   "dw_mm_dx_mask_s1")
               else dw_conv.LIBRARY if name in ("dw_act_s1",
                                                "dw_act_wgrad_s1",
                                                "dw_mm_wgrad_s1")
               else dw_conv.LIBRARY_S2 if name in ("dw_act_s2",
                                                   "dw_act_dx_s2",
                                                   "dw_act_wgrad_s2",
                                                   "dw_mm_act_s2",
                                                   "dw_mm_dx_mask_s2",
                                                   "dw_mm_wgrad_s2")
               else dw_mm_act.LIBRARY)
        assert name in lib.functions
        assert f'extern "C" int {name}(' in lib.source.read_text()
    for lib in dw_act.LIBRARIES:  # every bound name is exported
        src = lib.source.read_text()
        for name in lib.functions:
            assert f'extern "C" int {name}(' in src
