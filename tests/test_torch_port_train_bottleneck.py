"""The port's X3D bottleneck in training mode against the JAX package, on
the CPU in f32, with the same variables (filled from a numpy seed, carried
by ``ckpt.from_jax``): against the plain-layout ``Bottleneck`` and against
``FoldedBottleneck`` with the Pallas kernels under the interpreter, whose
training entry with ``dw_impl='interpret'`` is the matmul-fused composite
``dw_fold4_mm_bn_train`` (the ``mm`` modes of K1/K4, K2/K9 and the ``mm``
modes of K6/K10): the port's act route against the JAX composite."""

import pytest
import torch

from _torch_port_util import bottleneck_train_parity

torch.set_num_threads(2)


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
    bottleneck_train_parity(c_in, stride, use_se, down, fold)
