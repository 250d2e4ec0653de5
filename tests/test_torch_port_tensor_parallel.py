"""The port's tensor-parallel fine tower (``parallel/tensor.py``) and
``channel_pad`` (``models/x3d.py``, ``models/fine.py``) against the JAX
package's ``parallel/tensor.py``.

* ``FineNet(channel_pad=p)`` has the shapes of the JAX package's
  ``channel_pad`` clone, at X3D-M and X3D-XL, tensor for tensor after
  ``state_dict_from_jax``;
* ``pad_tower_state_dict`` of converted variables equals the converted
  ``pad_tower_variables`` of the same variables, exactly (at two
  batch-norm splits too: the split statistics pad per split);
* the padded tower equals the unpadded one in eval (2e-4 of each bank's
  largest magnitude: zero padding is exact, the products sum in another
  order);
* the tensor-parallel tower over 2 and 4 CPU shards (``make_tp_tower``:
  widths padded to 8·N, each shard's slices run through the kernels' plain
  versions) equals the unpadded tower and JAX's ``tp_tower_apply`` on its
  2×4 mesh (2e-4), the global tower's banks and the logits head's output;
* ``tower_param_specs`` shards the tensors JAX's specs shard, on the same
  axes in the port's layout, and ``tp_param_bytes`` counts one shard's
  share of them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.models.fine import FineNet as JFine
from coarse_fine_networks_tpu.parallel.tensor import (MODEL_AXIS,
                                                      make_mesh2d)
from coarse_fine_networks_tpu.parallel.tensor import \
    make_tp_tower as jmake_tp_tower
from coarse_fine_networks_tpu.parallel.tensor import pad_tower_variables
from coarse_fine_networks_tpu.parallel.tensor import \
    tower_param_specs as jtower_param_specs
from coarse_fine_networks_tpu.parallel.tensor import tp_tower_apply
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.models import FineNet, set_bn_splits
from coarse_fine_networks_torch.parallel.tensor import (
    make_tp_tower, pad_tower_state_dict, tower_param_specs, tp_param_bytes)

from _torch_port_util import jax_variables

torch.set_num_threads(2)

B, T, HW = 2, 4, 32
TOL = 2e-4


def _jtower(version="M", **kw):
    return JFine(version=version, n_classes=17, task="loc",
                 global_tower=kw.pop("global_tower", True),
                 trunk_layout="plain", dw_impl="lax", **kw)


def _clips(seed=0):
    return np.random.RandomState(seed).rand(B, T, HW, HW, 3).astype(
        np.float32)


def _port(v, **kw):
    m = FineNet("M", 17, task="loc", **kw)
    m.load_state_dict(state_dict_from_jax(v), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def tower():
    """The JAX global tower's numpy-filled variables and the port's tower
    loaded with them."""
    v = jax_variables(_jtower(), jnp.asarray(_clips()), train=False)
    return v, _port(v)


def _close(got, ref, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("version,pad", [("M", 4), ("M", 16), ("XL", 8)])
def test_padded_shapes_equal_jax_clone(version, pad):
    jm = _jtower(version, channel_pad=pad)
    shapes = jax.eval_shape(lambda c: jm.init(jax.random.PRNGKey(0), c,
                                              False),
                            jnp.zeros((1, T, HW, HW, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = {k: tuple(x.shape) for k, x in state_dict_from_jax(zeros).items()}
    got = {k: tuple(x.shape) for k, x in
           FineNet(version, 17, channel_pad=pad).state_dict().items()}
    assert got == ref


@pytest.mark.parametrize("splits", [1, 2])
def test_pad_state_dict_equals_jax_pad_tower_variables(splits):
    jm = _jtower(bn_splits=splits)
    v = jax_variables(jm, jnp.asarray(_clips()), seed=splits, train=False)
    clone = jm.clone(channel_pad=16)
    shapes = jax.eval_shape(lambda c: clone.init(jax.random.PRNGKey(0), c,
                                                 False),
                            jnp.zeros((1, T, HW, HW, 3)))
    ref = state_dict_from_jax(jax.device_get(pad_tower_variables(v, shapes)))
    target = set_bn_splits(FineNet("M", 17, channel_pad=16), splits)
    got = pad_tower_state_dict(state_dict_from_jax(v), target.state_dict())
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_padded_tower_equals_unpadded(tower):
    v, m = tower
    padded = FineNet("M", 17, channel_pad=16)
    padded.load_state_dict(pad_tower_state_dict(m.state_dict(),
                                                padded.state_dict()))
    x = torch.from_numpy(_clips(1))
    with torch.no_grad():
        ref, got = m(x), padded.eval()(x)
    for k in ref:
        _close(got[k], ref[k], k)


@pytest.fixture(scope="module")
def jax_tp(tower):
    """JAX's tensor-parallel tower on its (data 2, model 4) mesh."""
    v, _ = tower
    jm = _jtower()
    mesh = make_mesh2d(2, 4)
    clips = jnp.asarray(_clips(1))
    tp_model, tp_vars = jmake_tp_tower(jm, v, mesh, clips)
    apply_tp, data_sh = tp_tower_apply(tp_model, mesh)
    return jax.device_get(apply_tp(tp_vars, jax.device_put(clips, data_sh)))


@pytest.mark.parametrize("n", [2, 4])
def test_tp_tower_equals_unpadded_and_jax(tower, jax_tp, n):
    _, m = tower
    tp = make_tp_tower(m, ["cpu"] * n)
    assert tp.model.channel_pad == 8 * n
    assert tp.model.layer1[0].conv1.out_channels % (8 * n) == 0
    x = torch.from_numpy(_clips(1))
    with torch.no_grad():
        ref = m(x)
    got = tp(x)
    assert set(got) == set(ref) == set(jax_tp)
    for k in ref:
        _close(got[k], ref[k], k)
        _close(got[k], jax_tp[k], k)


def test_tp_logits_head_equals_unpadded():
    """The head's conv5 column-parallel and fc1 row-parallel: the logits
    of ``FineNet(global_tower=False)`` over 2 shards."""
    jm = _jtower(global_tower=False)
    v = jax_variables(jm, jnp.asarray(_clips()), seed=4, train=False)
    m = _port(v, global_tower=False)
    x = torch.from_numpy(_clips(2))
    with torch.no_grad():
        ref = m(x)
    _close(make_tp_tower(m, ["cpu", "cpu"])(x), ref, "logits")


def test_specs_shard_what_jax_shards(tower):
    """Each JAX spec with the model axis at kernel axis 4 (the output
    channels) is the port's dim 0, at axis 3 (the input channels) dim 1,
    a sharded bias dim 0; every replicated leaf is whole in the port
    (the batch-norm vectors, which the port slices with the channels and
    JAX's mesh replicates, aside)."""
    v, m = tower
    flat = {tuple(getattr(k, "key", str(k)) for k in kp): s for kp, s in
            jax.tree_util.tree_flatten_with_path(jtower_param_specs(v))[0]}
    names = list(state_dict_from_jax(v))
    # the converter's key for each flax leaf, in the same order
    leaves = [p for p, _ in jax.tree_util.tree_flatten_with_path(v)[0]]
    assert len(leaves) == len(names)
    specs = tower_param_specs(m.state_dict())
    want = {}
    for kp in leaves:
        path = tuple(getattr(k, "key", str(k)) for k in kp)
        spec = tuple(flat[path])
        leaf = path[-1]
        axis = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
        dim = None if axis is None else (0 if leaf == "bias" or axis == 4
                                         else 1)
        want[path] = dim
    got_dims = sorted(d for d in specs.values() if d is not None)
    want_dims = sorted(d for d in want.values() if d is not None)
    assert got_dims == want_dims
    assert specs["layer1.0.conv1.weight"] == 0
    assert specs["layer1.0.conv2.weight"] == 0
    assert specs["layer1.0.fc2.bias"] == 0
    assert specs["layer1.0.fc1.weight"] == 1
    assert specs["layer1.0.conv3.weight"] == 1
    assert specs["conv5.weight"] == 0
    assert specs["conv1_s.weight"] is None
    assert specs["layer1.0.downsample.0.weight"] is None
    total, per = tp_param_bytes(m.state_dict(), 4)
    sharded = sum(m.state_dict()[k].numel() * 4 for k, d in specs.items()
                  if d is not None)
    assert total == sum(x.numel() * 4 for x in m.state_dict().values())
    assert per == total - sharded + sharded // 4
