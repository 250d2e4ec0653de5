"""The port's matmul-fused bottleneck entry in training and its backward
(``ops/dw_mm_bn_train.py``, ``ops/dw_mm_act.py``): the plain versions of the
four new kernel entries, and the two autograd Functions built on them.

The plain versions are held against the JAX Pallas kernels themselves, run
in interpret mode on the CPU as ``tests/test_dw_fold.py`` runs them: K2 and
K9 (dx masked by the recomputed ``relu'((x @ W1)·sc + bi)``) and the ``mm``
modes of K6/K10 (weight gradient of the taps over the recomputed
activation), at 1e-4 absolute and relative (f32 sums of 27 taps, of
``C_in`` products and of up to 2·4·8·8 positions in other orders).  The
composite ``DwMmBnTrain`` is held against ``jax.vjp`` of
``dw_fold4_mm_bn_train`` and the eval entry's ``DwMmBnReluConv3d`` against
``jax.vjp`` of ``dw_fold4_mm_act``, both with the Pallas kernels under the
interpreter, at the tolerances ``tests/test_dw_fold.py`` holds them to
against XLA (composite: ``(mean, var)`` 1e-4 relative and 1e-5 absolute,
gradients 2e-3 relative and 1e-4 of the gradient's largest magnitude, since
the batch norm's closed form makes dW1 a near-cancelling sum of three large
terms; eval entry: gradients 5e-4; the outputs at 1e-4).  Odd sizes, which
the fold4 kernels do not take, are held against autograd through the plain
composition (product → batch statistics → apply → relu →
``F.conv3d(groups=C)``) in float64 at 1e-4 of each tensor's largest
magnitude.  The CUDA kernels only run on the card: ``chip_smoke.py`` holds
them against these plain versions there."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.ops.fold import (fold_pad, fold_pointwise_kernel,
                                               from_fold4, pad_vec, to_fold4)
from coarse_fine_networks_tpu.ops.pallas.dw_fold import (
    FOLD, _dw_fold4_wgrad_raw, _dx_mask_raw, _dx_s2_mask_raw,
    _prep_lane_weights, _wgrad_s2_raw, dw_fold4_mm_act, dw_fold4_mm_bn_train)
from coarse_fine_networks_torch.models import Bottleneck
from coarse_fine_networks_torch.ops import dw_mm_act, dw_mm_bn_train
from coarse_fine_networks_torch.ops.dw_mm_act import (
    dw_mm_bnrelu_conv3d_plain, dw_mm_bnrelu_conv3d_train, dw_mm_wgrad,
    dw_mm_wgrad_plain)
from coarse_fine_networks_torch.ops.dw_mm_bn_train import (
    dw_mm_dx_mask, dw_mm_dx_mask_plain, mm_bn_train)

from _torch_port_util import t

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
C_IN, C = 24, 54  # layer1's widths: C_mid no multiple of 8 or 32
EPS = 1e-5


def _inputs(shape, seed, stride=1, c=C):
    """x, w1, taps, sc, bi, gamma, beta and a cotangent g of y's shape;
    half the channels get a negative bi, so relu(bi) != 0 and the zero
    frame matters."""
    rng = np.random.RandomState(seed)
    b, tt, h, w, c_in = shape
    x = rng.randn(*shape).astype(np.float32)
    w1 = (rng.randn(c_in, c) / np.sqrt(c_in)).astype(np.float32)
    k = (rng.randn(3, 3, 3, c) / np.sqrt(27)).astype(np.float32)
    sc = (rng.rand(c) + 0.5).astype(np.float32)
    bi = rng.randn(c).astype(np.float32)
    bi[: c // 2] = -np.abs(bi[: c // 2]) - 0.5
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = (rng.randn(c) / 3).astype(np.float32)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = rng.randn(b, tt, ho, wo, c).astype(np.float32)
    return x, w1, k, sc, bi, gamma, beta, g


def _lanes(v, c=C):
    return pad_vec(jnp.asarray(v), c, fold_pad(c))


def _wmm(w1):
    c_in, c = w1.shape
    return fold_pointwise_kernel(jnp.asarray(w1).reshape(1, 1, 1, c_in, c),
                                 c_in, c)


def _phase_sum(v, c=C):
    """(…, 4P) per-lane values → (…, C) per-channel sums."""
    v = np.asarray(v)
    return v.reshape(v.shape[:-1] + (FOLD, v.shape[-1] // FOLD)).sum(-2)[
        ..., :c]


SHAPE = (2, 4, 16, 16, C_IN)


@pytest.mark.parametrize("stride", [1, 2])
def test_dx_mask_plain_matches_pallas(stride):
    """K2 (stride 1: the stencil of g with the flipped taps) and K9 (stride
    2: the half-resolution gather), each masked by the relu' of the product
    recomputed from x."""
    x, w1, k, sc, bi, _, _, g = _inputs(SHAPE, seed=stride, stride=stride)
    kj = jnp.asarray(k).reshape(3, 3, 3, 1, C)
    if stride == 1:
        raw, kj = _dx_mask_raw, jnp.flip(kj, axis=(0, 1, 2))
    else:
        raw = _dx_s2_mask_raw
    dam = raw(to_fold4(jnp.asarray(g)), _prep_lane_weights(kj, C, fold_pad(C)),
              True, sc=_lanes(sc), bi=_lanes(bi), wmm=_wmm(w1),
              x2=to_fold4(jnp.asarray(x)))
    got = dw_mm_dx_mask_plain(t(g), t(x), t(w1), t(k), t(sc), t(bi), stride)
    ref = np.asarray(from_fold4(dam, C))
    assert got.shape == ref.shape == x.shape[:-1] + (C,)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_wgrad_plain_matches_pallas(stride):
    """The ``mm`` modes of K6 and K10: the taps' gradient over the forward's
    recomputed, rounded, zero-padded activation."""
    x, w1, _, sc, bi, _, _, g = _inputs(SHAPE, seed=10 + stride,
                                        stride=stride)
    raw = _dw_fold4_wgrad_raw if stride == 1 else _wgrad_s2_raw
    dk = raw(to_fold4(jnp.asarray(x)), to_fold4(jnp.asarray(g)), True,
             sc=_lanes(sc), bi=_lanes(bi), wmm=_wmm(w1))
    got = dw_mm_wgrad_plain(t(x), t(w1), t(g), t(sc), t(bi), stride)
    assert got.shape == (27, C)
    np.testing.assert_allclose(got.numpy(), _phase_sum(dk), **TOL)


def _close(got, ref, rtol, atol, name):
    np.testing.assert_allclose(got.detach().reshape(np.shape(ref)).numpy(),
                               np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("stride", [1, 2])
def test_composite_matches_jax_vjp(stride):
    """``(y, mean, var)`` and the five gradients (dx, dw1, dk, dgamma,
    dbeta) of ``DwMmBnTrain`` against ``jax.vjp`` of
    ``dw_fold4_mm_bn_train`` (K1/K4 ``mm``, K2/K9 and K6/K10 ``mm`` under
    the interpreter)."""
    x, w1, k, _, _, gamma, beta, g = _inputs(SHAPE, seed=20 + stride,
                                             stride=stride)

    def f(x, w1, k, gamma, beta):
        y, mean, var = dw_fold4_mm_bn_train(to_fold4(x), _wmm(w1), k, gamma,
                                            beta, C, stride, EPS, True)
        return from_fold4(y, C), mean, var

    (y, mean, var), vjp = jax.vjp(
        f, *(jnp.asarray(a) for a in (x, w1, k.reshape(3, 3, 3, 1, C), gamma,
                                       beta)))
    grads = vjp((jnp.asarray(g), jnp.zeros_like(mean), jnp.zeros_like(var)))

    leaves = [t(a).requires_grad_() for a in (x, w1, k, gamma, beta)]
    yt, mt, vt = mm_bn_train(*leaves, stride, EPS)
    yt.backward(t(g))
    _close(yt, y, 1e-4, 1e-4, "y")
    _close(mt, mean, 1e-4, 1e-5, "mean")
    _close(vt, var, 1e-4, 1e-5, "var")
    for name, leaf, ref in zip(("dx", "dw1", "dk", "dgamma", "dbeta"), leaves,
                               grads):
        ref = np.asarray(ref)
        _close(leaf.grad, ref, 2e-3, 1e-4 * max(np.abs(ref).max(), 1.0),
               name)


@pytest.mark.parametrize("stride", [1, 2])
def test_eval_entry_function_matches_jax_vjp(stride):
    """The eval entry's ``DwMmBnReluConv3d``: ``y`` and the five gradients
    (dx, dw1, dk, dsc, dbi) against ``jax.vjp`` of ``dw_fold4_mm_act``
    (its custom VJP ``_dw_mm_bwd``: K1 plain on the flipped taps or K8, and
    K6/K10 ``mm``, under the interpreter)."""
    x, w1, k, sc, bi, _, _, g = _inputs(SHAPE, seed=30 + stride,
                                        stride=stride)

    def f(x, w1, k, sc, bi):
        return from_fold4(dw_fold4_mm_act(to_fold4(x), _wmm(w1), k, sc, bi, C,
                                          stride, True), C)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w1),
                     jnp.asarray(k).reshape(3, 3, 3, 1, C), _lanes(sc),
                     _lanes(bi))
    gx, gw1, gk, gsc, gbi = vjp(jnp.asarray(g))

    leaves = [t(a).requires_grad_() for a in (x, w1, k, sc, bi)]
    yt = dw_mm_bnrelu_conv3d_train(*leaves, stride)
    yt.backward(t(g))
    _close(yt, y, 1e-4, 1e-4, "y")
    for name, leaf, ref in zip(
            ("dx", "dw1", "dk", "dsc", "dbi"), leaves,
            (gx, gw1, gk, _phase_sum(gsc), _phase_sum(gbi))):
        _close(leaf.grad, ref, 5e-4, 5e-4, name)


def _plain_composite(x, w1, k, gamma, beta, stride):
    """The composite by autograd through the plain composition."""
    z = x @ w1
    mean = z.mean((0, 1, 2, 3))
    var = (z * z).mean((0, 1, 2, 3)) - mean * mean
    a = torch.relu((z - mean) * torch.rsqrt(var + EPS) * gamma + beta)
    return _conv(a, k, stride), mean, var


def _conv(a, k, stride):
    return F.conv3d(a.permute(0, 4, 1, 2, 3),
                    k.permute(3, 0, 1, 2).unsqueeze(1), stride=(1, stride,
                                                                stride),
                    padding=1, groups=a.shape[-1]).permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(7, 7), (5, 9)])
def test_functions_odd_sizes_against_autograd(hw, stride):
    """Odd H, W (layer4 runs at 7×7; K9 takes the ragged edge): both
    Functions' outputs and gradients against float64 autograd through the
    plain composition, from the same f32 inputs."""
    x, w1, k, sc, bi, gamma, beta, g = _inputs((2, 3) + hw + (16,), seed=40,
                                               stride=stride, c=20)

    def check(fn, ref_fn, inputs, names):
        leaves = [t(a).requires_grad_() for a in inputs]
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        out[0].backward(t(g))
        ref_leaves = [t(a).double().requires_grad_() for a in inputs]
        ref = ref_fn(*ref_leaves)
        ref = ref if isinstance(ref, tuple) else (ref,)
        ref[0].backward(t(g).double())
        pairs = list(zip(out, ref)) + [(a.grad, b.grad) for a, b in
                                       zip(leaves, ref_leaves)]
        for name, (got, want) in zip(names, pairs):
            got, want = got.detach(), want.detach()
            assert got.shape == want.shape, name
            err = float((got.double() - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (name, err)

    check(lambda *a: mm_bn_train(*a, stride, EPS),
          lambda *a: _plain_composite(*a, stride), (x, w1, k, gamma, beta),
          ("y", "mean", "var", "dx", "dw1", "dk", "dgamma", "dbeta"))
    check(lambda *a: dw_mm_bnrelu_conv3d_train(*a, stride),
          lambda x, w1, k, sc, bi: _conv(torch.relu(x @ w1 * sc + bi), k,
                                         stride),
          (x, w1, k, sc, bi), ("y", "dx", "dw1", "dk", "dsc", "dbi"))


def test_wrappers_cpu_take_plain_and_count_nothing():
    x, w1, k, sc, bi, _, _, g1 = _inputs((1, 3, 6, 6, 8), seed=50, c=12)
    g2 = _inputs((1, 3, 6, 6, 8), seed=50, stride=2, c=12)[-1]
    dw_mm_act.reset_launches()
    dw_mm_bn_train.reset_launches()
    for s, g in ((1, g1), (2, g2)):
        d = (t(g), t(x), t(w1), t(k), t(sc), t(bi), s)
        assert torch.equal(dw_mm_dx_mask(*d), dw_mm_dx_mask_plain(*d))
        w = (t(x), t(w1), t(g), t(sc), t(bi), s)
        assert torch.equal(dw_mm_wgrad(*w), dw_mm_wgrad_plain(*w))
    assert set(dw_mm_bn_train.LAUNCHES) == {"dw_mm_dx_mask_s1",
                                            "dw_mm_dx_mask_s2"}
    assert {"dw_mm_wgrad_s1", "dw_mm_wgrad_s2"} <= set(dw_mm_act.LAUNCHES)
    assert not any(dw_mm_bn_train.LAUNCHES.values())
    assert not any(dw_mm_act.LAUNCHES.values())


def test_bf16_keeps_dtypes_and_rounds_activation():
    """bf16: dam is in g's dtype, the weight gradient f32 over the
    activation rounded to bf16; the Functions return gradients in their
    inputs' dtypes."""
    x, w1, k, sc, bi, gamma, beta, g = _inputs((1, 2, 4, 4, 8), seed=60, c=8)
    xb, wb, kb, gb = (t(a).bfloat16() for a in (x, w1, k, g))
    a = torch.relu(xb.float() @ wb.float() * t(sc) + t(bi)).bfloat16()
    eye, one, zero = torch.eye(8).bfloat16(), torch.ones(8), torch.zeros(8)
    dk = dw_mm_wgrad(xb, wb, gb, t(sc), t(bi), 1)
    assert dk.dtype == torch.float32
    assert torch.equal(dk, dw_mm_wgrad(a, eye, gb, one, zero, 1))
    assert dw_mm_dx_mask(gb, xb, wb, kb, t(sc), t(bi), 1).dtype == \
        torch.bfloat16
    leaves = [v.clone().requires_grad_() for v in (xb, wb, kb)]
    y, mean, var = mm_bn_train(*leaves, t(gamma), t(beta), 1, EPS)
    assert y.dtype == torch.bfloat16 and mean.dtype == var.dtype == \
        torch.float32
    y.backward(gb)
    assert all(v.grad.dtype == torch.bfloat16 for v in leaves)


@pytest.mark.parametrize("bad", ["dtype", "w1", "w_dw", "sc", "stride", "g",
                                 "noncontig", "device"])
def test_wrappers_reject(bad):
    x, w1, k, sc, bi, _, _, g = (t(a) for a in _inputs((1, 2, 4, 4, 8),
                                                       seed=70, c=8))
    stride = 1
    if bad == "dtype":
        x = x.double()
    elif bad == "w1":
        w1 = w1[:4]
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
        x, w1, k, sc, bi, g = (a.to("meta") for a in (x, w1, k, sc, bi, g))
    with pytest.raises((ValueError, TypeError)):
        dw_mm_dx_mask(g, x, w1, k, sc, bi, stride)
    if bad != "w_dw":
        with pytest.raises((ValueError, TypeError)):
            dw_mm_wgrad(x, w1, g, sc, bi, stride)


def test_eval_bottleneck_grads_reach_conv1_conv2_bn1(monkeypatch):
    """The eval entry has a backward: with the kernel wrapper replaced by
    one that returns a tensor outside autograd, as a launch on the card
    does, an eval-mode Bottleneck's gradients still reach conv1, conv2 and
    bn1 (through ``DwMmBnReluConv3d``), and equal those of autograd through
    the plain version."""
    torch.manual_seed(0)
    block = Bottleneck(24, 54, 24, stride=2, use_se=True,
                       has_downsample=True).eval()
    with torch.no_grad():
        for name, buf in block.named_buffers():
            if name.startswith("bn1.bn."):
                buf.copy_(torch.rand_like(buf) + 0.5 if "var" in name
                          else torch.randn_like(buf) * 0.2)
    x = torch.randn(2, 3, 8, 8, 24)
    g = torch.randn(2, 3, 4, 4, 24)
    tracked = ("conv1.weight", "conv2.weight", "bn1.weight", "bn1.bias")

    def grads():
        block.zero_grad(set_to_none=True)
        block(x).backward(g)
        params = dict(block.named_parameters())
        return {k: params[k].grad for k in tracked}

    monkeypatch.setattr(
        "coarse_fine_networks_torch.models.x3d.dw_mm_bnrelu_conv3d_train",
        lambda *a: dw_mm_bnrelu_conv3d_plain(*a))  # differentiable
    ref = grads()
    monkeypatch.undo()
    # what the wrapper returns on a CPU tensor, now outside autograd
    monkeypatch.setattr(
        "coarse_fine_networks_torch.ops.dw_mm_act.dw_mm_bnrelu_conv3d_plain",
        lambda *a: dw_mm_bnrelu_conv3d_plain(*a).detach())
    got = grads()
    for k in tracked:
        assert got[k] is not None and float(got[k].abs().max()) > 0, k
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), **TOL,
                                   err_msg=k)
