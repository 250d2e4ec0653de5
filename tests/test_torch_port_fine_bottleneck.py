"""The port's X3D bottleneck in training with split batch norm
(``bn1.num_splits = 2``, the multigrid long cycle's route) against the JAX
package, on the CPU in f32, with the same variables (filled from a numpy
seed, carried by ``ckpt.from_jax``): against the plain-layout
``Bottleneck(bn_splits=2)`` and against
``FoldedBottleneck(bn_splits=2, dw_impl="interpret")``, whose depthwise
conv runs the plain modes of the Pallas kernels K1/K4, K8 and K6/K10 under
the interpreter."""

import pytest
import torch

from _torch_port_util import bottleneck_train_parity

torch.set_num_threads(2)


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold4"])
@pytest.mark.parametrize("c_in,stride,use_se,down", [
    (24, 1, True, False), (24, 2, True, True)])
def test_bottleneck_train_split_bn(c_in, stride, use_se, down, fold):
    """conv1 → bn1 per split → relu → the plain depthwise conv with its
    kernel backward → bn2, SE, swish, conv3, bn3, downsample and residual,
    all with two splits, batch 4 (sample i in split i % 2): output, the
    gradient of the input and the new split statistics (2·C each) within
    1e-4 relative and absolute; every parameter's gradient within 1e-5 of
    its largest magnitude.  The gradients reach 285 (sums over 4·3·16·16
    positions), where f32 rounding in another order is 1e-4 absolute: the
    JAX package's own plain and fold4 layouts differ by up to 1.9e-4 in
    these tensors (7e-7 of their largest magnitude)."""
    bottleneck_train_parity(c_in, stride, use_se, down, fold, splits=2,
                            batch=4, grad_rel=1e-5)
