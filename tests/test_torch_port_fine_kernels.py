"""The port's plain depthwise conv of the split-batch-norm route
(``ops/dw_conv.py``): the plain versions of its five kernel entries, and
the autograd Function built on them.

The plain versions are held against the JAX Pallas kernels themselves, run
in interpret mode on the CPU as ``tests/test_dw_fold.py`` runs them: the
plain modes of K1/K4 (forward; K1 on the flipped taps is also the stride-1
dx), K8 (stride-2 dx) and the plain modes of K6/K10 (weight gradient); the
Function's two gradients against ``jax.vjp`` of ``dw_fold4`` and
``dw_fold4_stride2``; and odd sizes, which the fold4 kernels do not take
(phase B of the long cycle reaches layer4.0 at 9×9 → 5×5), against XLA's
conv and ``jax.grad``.  The CUDA kernels only run on the card:
``chip_smoke.py`` holds them against these plain versions there.

All f32.  Tolerance 1e-4 absolute and relative: f32 sums of 27 taps (and of
up to 2·4·16·16 positions for the weight gradient) in different orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from coarse_fine_networks_tpu.ops.fold import fold_pad, from_fold4, to_fold4
from coarse_fine_networks_tpu.ops.pallas.dw_fold import (
    FOLD, _dw_fold4_raw, _dw_fold4_wgrad_raw, _dx_s2_raw, _fwd_s2_direct_raw,
    _prep_lane_weights, _wgrad_s2_raw, dw_fold4, dw_fold4_stride2)
from coarse_fine_networks_torch.ops import dw_conv
from coarse_fine_networks_torch.ops.dw_conv import (
    dw_conv3d, dw_conv3d_plain, dw_conv3d_train, dw_conv_dx_s2,
    dw_conv_dx_s2_plain, dw_conv_wgrad, dw_conv_wgrad_plain)

from _torch_port_util import t

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
C = 54  # layer1's C_mid: no multiple of 8 or 32
SHAPE = (2, 4, 16, 16, C)


def _inputs(shape, seed, stride=1):
    """x (the activated conv1 output: relu of a normal draw), taps and a
    cotangent g of y's shape."""
    rng = np.random.RandomState(seed)
    b, tt, h, w, c = shape
    x = np.maximum(rng.randn(*shape), 0).astype(np.float32)
    k = (rng.randn(3, 3, 3, c) / np.sqrt(27)).astype(np.float32)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = rng.randn(b, tt, ho, wo, c).astype(np.float32)
    return x, k, g


def _lane_w(k, c=C):
    return _prep_lane_weights(jnp.asarray(k).reshape(3, 3, 3, 1, c), c,
                              fold_pad(c))


def _phase_sum(v, c=C):
    """(27, 4P) per-lane sums → (27, C) per-channel sums."""
    v = np.asarray(v)
    return v.reshape(v.shape[:-1] + (FOLD, v.shape[-1] // FOLD)).sum(-2)[
        ..., :c]


@pytest.mark.parametrize("stride", [1, 2])
def test_forward_plain_matches_pallas(stride):
    """K1 plain (stride 1) and K4 plain (stride 2)."""
    x, k, _ = _inputs(SHAPE, seed=stride)
    raw = _dw_fold4_raw if stride == 1 else _fwd_s2_direct_raw
    ref = np.asarray(from_fold4(raw(to_fold4(jnp.asarray(x)), _lane_w(k),
                                    True), C))
    got = dw_conv3d_plain(t(x), t(k), stride)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_dx_s1_is_the_forward_on_flipped_taps():
    """Stride-1 dx: K1 plain on g with the flipped taps, as
    ``_dw_fold4_bwd`` runs it, against the port's backward."""
    x, k, g = _inputs(SHAPE, seed=3)
    kf = np.ascontiguousarray(k[::-1, ::-1, ::-1])
    ref = np.asarray(from_fold4(_dw_fold4_raw(to_fold4(jnp.asarray(g)),
                                              _lane_w(kf), True), C))
    xt = t(x).requires_grad_()
    dw_conv3d_train(xt, t(k), 1).backward(t(g))
    np.testing.assert_allclose(xt.grad.numpy(), ref, **TOL)


def test_dx_s2_plain_matches_pallas():
    """K8: the half-resolution g gathered to a full-resolution dx."""
    x, k, g = _inputs(SHAPE, seed=4, stride=2)
    ref = np.asarray(from_fold4(_dx_s2_raw(to_fold4(jnp.asarray(g)),
                                           _lane_w(k), True), C))
    got = dw_conv_dx_s2_plain(t(g), t(k), x.shape[2:4])
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_wgrad_plain_matches_pallas(stride):
    """K6 plain (stride 1) and K10 plain (stride 2)."""
    x, _, g = _inputs(SHAPE, seed=5 + stride, stride=stride)
    raw = _dw_fold4_wgrad_raw if stride == 1 else _wgrad_s2_raw
    dk = raw(to_fold4(jnp.asarray(x)), to_fold4(jnp.asarray(g)), True)
    got = dw_conv_wgrad_plain(t(x), t(g), stride)
    assert got.shape == (27, C)
    np.testing.assert_allclose(got.numpy(), _phase_sum(dk), **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_function_matches_jax_vjp(stride):
    """``(dx, dw)`` of the autograd Function against ``jax.vjp`` of
    ``dw_fold4`` / ``dw_fold4_stride2`` (the Pallas kernels under the
    interpreter)."""
    x, k, g = _inputs(SHAPE, seed=10 + stride, stride=stride)
    op = dw_fold4 if stride == 1 else dw_fold4_stride2

    def f(x, k):
        return from_fold4(op(to_fold4(x), k, C, True), C)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(k).reshape(3, 3, 3, 1, C))
    gx, gk = vjp(jnp.asarray(g))
    xt, kt = t(x).requires_grad_(), t(k).requires_grad_()
    yt = dw_conv3d_train(xt, kt, stride)
    yt.backward(t(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(kt.grad.numpy(),
                               np.asarray(gk).reshape(3, 3, 3, C), **TOL)


def _xla_loss(x, k, g, stride):
    y = lax.conv_general_dilated(
        x, k.reshape(3, 3, 3, 1, -1), (1, stride, stride), [(1, 1)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        feature_group_count=x.shape[-1], precision=lax.Precision.HIGHEST)
    return jnp.sum(y * g), y


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(7, 7), (5, 9), (9, 9)])
def test_odd_sizes_against_xla_and_jax_grad(hw, stride):
    """Odd H, W (phase B's 144² crop reaches layer3.0 at 18² → 9² and
    layer4.0 at 9² → 5²): forward and both gradients against an XLA conv
    and ``jax.grad``."""
    x, k, g = _inputs((2, 3) + hw + (20,), seed=40, stride=stride)
    (_, y), grads = jax.value_and_grad(_xla_loss, argnums=(0, 1),
                                       has_aux=True)(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(g), stride)
    xt, kt = t(x).requires_grad_(), t(k).requires_grad_()
    yt = dw_conv3d_train(xt, kt, stride)
    assert yt.shape == y.shape
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **TOL)
    torch.sum(yt * t(g)).backward()
    for got, ref in zip((xt.grad, kt.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_wrappers_cpu_take_plain_and_count_nothing():
    x, k, g1 = _inputs((1, 3, 7, 6, 12), seed=50)
    _, _, g2 = _inputs((1, 3, 7, 6, 12), seed=50, stride=2)
    dw_conv.reset_launches()
    for s, g in ((1, g1), (2, g2)):
        assert torch.equal(dw_conv3d(t(x), t(k), s),
                           dw_conv3d_plain(t(x), t(k), s))
        assert torch.equal(dw_conv_wgrad(t(x), t(g), s),
                           dw_conv_wgrad_plain(t(x), t(g), s))
    assert torch.equal(dw_conv_dx_s2(t(g2), t(k), (7, 6)),
                       dw_conv_dx_s2_plain(t(g2), t(k), (7, 6)))
    # the stride-(2, 2, 2) kernels of FineNet's t_downsample too
    x3, _, g3 = _inputs((1, 5, 7, 6, 12), seed=51)
    g3 = g3[:, ::2, ::2, ::2].copy()
    assert torch.equal(dw_conv3d(t(x3), t(k), dw_conv.T2),
                       dw_conv3d_plain(t(x3), t(k), dw_conv.T2))
    assert torch.equal(dw_conv.dw_conv_dx_t2(t(g3), t(k), (5, 7, 6)),
                       dw_conv.dw_conv_dx_t2_plain(t(g3), t(k), (5, 7, 6)))
    assert torch.equal(dw_conv_wgrad(t(x3), t(g3), dw_conv.T2),
                       dw_conv_wgrad_plain(t(x3), t(g3), dw_conv.T2))
    assert set(dw_conv.LAUNCHES) == {
        "dw_conv_s1", "dw_conv_s2", "dw_conv_dx_s2", "dw_conv_wgrad_s1",
        "dw_conv_wgrad_s2", "dw_conv_t2", "dw_conv_dx_t2",
        "dw_conv_wgrad_t2"}
    assert not any(dw_conv.LAUNCHES.values())


def test_bf16_keeps_dtypes():
    """bf16: y and dx in bf16, the weight gradient f32 from the wrapper and
    in the taps' dtype from the Function."""
    x, k, g = _inputs((1, 2, 5, 5, 8), seed=60, stride=2)
    xb, kb, gb = (t(a).bfloat16() for a in (x, k, g))
    assert dw_conv3d(xb, kb, 2).dtype == torch.bfloat16
    assert dw_conv_dx_s2(gb, kb, (5, 5)).dtype == torch.bfloat16
    assert dw_conv_wgrad(xb, gb, 2).dtype == torch.float32
    xr, kr = xb.clone().requires_grad_(), kb.clone().requires_grad_()
    dw_conv3d_train(xr, kr, 2).backward(gb)
    assert xr.grad.dtype == kr.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["dtype", "w_dw", "stride", "g", "hw",
                                 "noncontig", "device"])
def test_wrappers_reject(bad):
    x, k, g = (t(a) for a in _inputs((1, 2, 4, 4, 8), seed=70, stride=2))
    stride, hw = 2, (4, 4)
    if bad == "dtype":
        x, g = x.double(), g.double()
    elif bad == "w_dw":
        k = k.reshape(27, 8)
    elif bad == "stride":
        stride = 3
    elif bad == "g":
        g = g[:, :, :1].contiguous()
    elif bad == "hw":
        hw = (6, 4)
    elif bad == "noncontig":
        x, g = x.transpose(2, 3), g.transpose(2, 3)
    else:  # no kernel and no plain version off the CPU and the card
        x, k, g = (a.to("meta") for a in (x, k, g))
    with pytest.raises((ValueError, TypeError)):
        if bad in ("g", "hw"):
            dw_conv_dx_s2(g, k, hw)
        else:
            dw_conv3d(x, k, stride)
    if bad not in ("w_dw", "hw"):
        with pytest.raises((ValueError, TypeError)):
            dw_conv_wgrad(x, g, stride)


def test_kernel_sources_ship_every_entry():
    """The stride-1 entries in ``dw_plain_s1.cu``, the three stride-2 ones
    in ``dw_plain_s2.cu``."""
    for name in dw_conv.LAUNCHES:
        lib = dw_conv.LIBRARY if name.endswith("_s1") else dw_conv.LIBRARY_S2
        assert f'extern "C" int {name}(' in lib.source.read_text()
        assert name in lib.functions
