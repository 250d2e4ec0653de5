"""The port's X3D bottleneck in training mode against the JAX package, on
the CPU in f32, with the same variables (filled from a numpy seed, carried
by ``ckpt.from_jax``): against the plain-layout ``Bottleneck`` and against
``FoldedBottleneck`` with the Pallas kernels (the ``act`` modes of K1/K4,
K3/K5 and the ``act`` modes of K6/K10) under the interpreter."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.models import x3d as jx3d
from coarse_fine_networks_tpu.models import x3d_fold as jxf
from coarse_fine_networks_tpu.ops.fold import from_fold4, to_fold4
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.models import Bottleneck

from _torch_port_util import jax_variables, load_port, nest, t

torch.set_num_threads(2)


def _close(got, ref, tol, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(ref), (name, got.shape, np.shape(ref))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol,
                               err_msg=name)


def _apply_train(jm, v, *args):
    """JAX train-mode apply: output, new batch_stats, and a VJP over
    (params, *args)."""
    def f(params, *a):
        return jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                        *a, True, mutable=["batch_stats"])
    y, vjp, upd = jax.vjp(f, v["params"], *(jnp.asarray(a) for a in args),
                          has_aux=True)
    return y, upd["batch_stats"], vjp


def _grads_by_name(jgrads, prefix):
    """JAX parameter gradients → port parameter names (under ``prefix``)."""
    sd = state_dict_from_jax(nest({"params": jgrads}, prefix))
    return sd


# ---- the bottleneck -------------------------------------------------------------

@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold4"])
@pytest.mark.parametrize("c_in,stride,use_se,down", [
    (24, 1, True, False), (24, 2, True, True), (48, 2, False, True)])
def test_bottleneck_train(c_in, stride, use_se, down, fold):
    """The training bottleneck (conv1 → bn1 batch statistics → the fused
    act-mode entry with its kernel backward → bn2, SE, swish, conv3, bn3,
    downsample, residual) against the JAX plain ``Bottleneck`` and against
    ``FoldedBottleneck`` with the Pallas kernels under the interpreter:
    output, the gradient of the input and of every parameter, and the new
    split statistics.  Tolerance 1e-4 relative and absolute (26 modules of
    f32 rounding, batch-norm backward sums over 2·3·16·16 positions)."""
    rng = np.random.RandomState(c_in + stride)
    x = rng.randn(2, 3, 16, 16, c_in).astype(np.float32)
    ho = 16 // stride
    g = rng.randn(2, 3, ho, ho, 24).astype(np.float32)
    plain = jx3d.Bottleneck(54, 24, stride=stride, use_se=use_se,
                            has_downsample=down)
    v = jax_variables(plain, jnp.asarray(x), train=False)
    if fold:
        jm = jxf.FoldedBottleneck(c_in, 54, 24, stride=stride, use_se=use_se,
                                  has_downsample=down, dw_impl="interpret")
        y, stats, vjp = _apply_train(jm, v, to_fold4(jnp.asarray(x)))
        y = from_fold4(y, 24)
        gp, gx = vjp(to_fold4(jnp.asarray(g)))
        gx = from_fold4(gx, c_in)
    else:
        y, stats, vjp = _apply_train(plain, v, x)
        gp, gx = vjp(jnp.asarray(g))

    prefix = ("layer1", "block0")
    pm = load_port(Bottleneck(c_in, 54, 24, stride, use_se, down), v, prefix,
                   "layer1.0.").train()
    xt = t(x).requires_grad_()
    yt = pm(xt)
    yt.backward(t(g))
    tol = 1e-4
    _close(yt, y, tol, "y")
    _close(xt.grad, gx, tol, "dx")
    jg = _grads_by_name(gp, prefix)
    names = dict(pm.named_parameters())
    assert {k[len("layer1.0."):] for k in jg} == set(names)
    for k, ref in jg.items():
        _close(names[k[len("layer1.0."):]].grad, ref.numpy(), tol, k)
    new = state_dict_from_jax(nest({"params": v["params"],
                                    "batch_stats": stats}, prefix))
    for k, ref in new.items():
        if "split_bn" in k:
            _close(pm.state_dict()[k[len("layer1.0."):]], ref.numpy(), tol, k)
