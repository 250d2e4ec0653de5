"""The port's modules against the JAX package's plain-layout modules, on
the CPU in f32, with the same variables (filled from a numpy seed, carried
by ``ckpt.from_jax``).  Tolerances are stated per test: 1e-4 for single
modules, looser where many blocks compound f32 rounding."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.ckpt.torch_convert import export_torch_state_dict
from coarse_fine_networks_tpu.models import coarse as jcoarse
from coarse_fine_networks_tpu.models import layers as jlayers
from coarse_fine_networks_tpu.models import x3d as jx3d
from coarse_fine_networks_tpu.models.pipeline import \
    CoarseFinePipeline as JPipeline
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.models import (
    Bottleneck, CoarseFinePipeline, CoarseNet, FineNet, GridPool,
    MixingLayer, RewightLayer, SqueezeExcite, SubBatchNorm, X3DStage,
    X3DStem, aggregate_sub_bn_stats, set_bn_splits)

from _torch_port_util import jax_variables, load_port, nest, t

torch.set_num_threads(2)


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(ref)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("c_in,stride,use_se,down", [
    (24, 1, True, False), (24, 1, False, False), (24, 2, True, True),
    (48, 2, False, True)])
def test_bottleneck(c_in, stride, use_se, down):
    x = _x((2, 3, 8, 8, c_in))
    jm = jx3d.Bottleneck(54, 24, stride=stride, use_se=use_se,
                         has_downsample=down)
    v = jax_variables(jm, jnp.asarray(x), train=False)
    pm = load_port(Bottleneck(c_in, 54, 24, stride, use_se, down), v,
                   ("layer1", "block0"), "layer1.0.")
    _close(pm(t(x)), jm.apply(v, jnp.asarray(x), False), 1e-4)


def test_bottleneck_train_mode_is_not_ported():
    """Training with split batch norm (``num_splits > 1``), the route this
    test showed unported before the plain depthwise kernels came: a small
    block with every batch norm at two splits, in training mode, against
    the JAX plain ``Bottleneck(bn_splits=2)``: the output and the new split
    statistics, 1e-4."""
    x = _x((4, 2, 4, 4, 8), seed=11)
    jm = jx3d.Bottleneck(16, 8, bn_splits=2)
    v = jax_variables(jm, jnp.asarray(x), train=False)
    y, upd = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    block = set_bn_splits(Bottleneck(8, 16, 8), 2)
    block = load_port(block, v, ("layer1", "block0"), "layer1.0.").train()
    _close(block(t(x)), y, 1e-4)
    new = state_dict_from_jax(nest({"params": v["params"], **upd},
                                   ("layer1", "block0")))
    for k, ref in new.items():
        if "split_bn" in k:
            assert ref.shape == (32 if "bn3" not in k else 16,)
            _close(block.state_dict()[k[len("layer1.0."):]], ref.numpy(),
                   1e-4)


@pytest.mark.parametrize("stride,h", [(1, 8), (2, 16), (2, 14)])
def test_x3d_stage(stride, h):
    x = _x((1, 3, h, h, 24), seed=1)
    jm = jx3d.X3DStage(108, 48, 3, stride=stride)
    v = jax_variables(jm, jnp.asarray(x), train=False)
    pm = load_port(X3DStage(24, 108, 48, 3, stride), v, ("layer2",),
                   "layer2.")
    _close(pm(t(x)), jm.apply(v, jnp.asarray(x), False), 1e-4)


def test_x3d_stem():
    x = _x((1, 6, 16, 16, 3), seed=2)
    jm = jx3d.X3DStem(24)
    v = jax_variables(jm, jnp.asarray(x), train=False)
    pm = load_port(X3DStem(24), v, ("stem",))
    _close(pm(t(x)), jm.apply(v, jnp.asarray(x), False), 1e-4)


def test_squeeze_excite():
    x = _x((2, 3, 4, 4, 54), seed=3)
    jm = jlayers.SqueezeExcite(54)
    v = jax_variables(jm, jnp.asarray(x))
    pm = load_port(SqueezeExcite(54), v)
    _close(pm(t(x)), jm.apply(v, jnp.asarray(x)), 1e-5)


def test_sub_batchnorm_and_aggregate():
    rng = np.random.RandomState(4)
    stats = {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32),
             "split_mean": rng.randn(18).astype(np.float32),
             "split_var": (rng.rand(18) + 0.5).astype(np.float32)}
    params = {"scale": (rng.rand(6) + 0.5).astype(np.float32),
              "bias": rng.randn(6).astype(np.float32)}
    agg = jlayers.aggregate_sub_bn_stats({"bn1": stats})["bn1"]
    pm = load_port(SubBatchNorm(6, num_splits=3),
                   {"params": params, "batch_stats": stats}, ("bn1",),
                   "bn1.")
    aggregate_sub_bn_stats(pm)
    _close(pm.bn.running_mean, agg["mean"], 1e-6)
    _close(pm.bn.running_var, agg["var"], 1e-6)
    x = _x((2, 2, 3, 3, 6), seed=5)
    jm = jlayers.SubBatchNorm(6, 3)
    ref = jm.apply({"params": params, "batch_stats": dict(agg)},
                   jnp.asarray(x), False)
    _close(pm(t(x)), ref, 1e-5)


def _fusion_inputs(b=2, tf=6, tc=5, seed=6):
    rng = np.random.RandomState(seed)
    mask = np.ones((b, tf), np.float32)
    mask[1, 4:] = 0
    return rng, mask, rng.rand(b, tf, tc).astype(np.float32)


@pytest.mark.parametrize("pool", [False, True])
def test_rewight_layer(pool):
    rng, mask, align = _fusion_inputs()
    feat = rng.randn(2, 6, 7, 7, 24).astype(np.float32)
    jm = jcoarse.RewightLayer(channels=16, g_channels=16, depth=24, pool=pool)
    args = (jnp.asarray(feat), jnp.asarray(mask), jnp.asarray(align))
    v = jax_variables(jm, *args, is_mixing=not pool, train=False)
    ref = jm.apply(v, *args, not pool, False)
    pm = load_port(RewightLayer(16, 24, pool=pool), v, ("rw2",), "rw2.")
    got = pm(t(feat), t(mask), t(align), not pool)
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)


@pytest.mark.parametrize("out_hw", [14, 8, 7, 4])
def test_mixing_layer_both_branches(out_hw):
    """Replication at out_hw >= 7 (maps stay 7×7), pool-first below."""
    rng = np.random.RandomState(out_hw)
    levels = (24, 48, 96, 192)
    bias = [rng.randn(2, 3, 7, 7, c).astype(np.float32) for c in levels]
    scale = [rng.randn(2, 3, 7, 7, c).astype(np.float32) for c in levels]
    jm = jcoarse.MixingLayer(depth=48)
    jb, js = [jnp.asarray(a) for a in bias], [jnp.asarray(a) for a in scale]
    v = jax_variables(jm, jb, js, out_hw=out_hw, train=False)
    ref = jm.apply(v, jb, js, out_hw, False)
    pm = load_port(MixingLayer(48), v, ("mix3",), "mix3.")
    got = pm([t(a) for a in bias], [t(a) for a in scale], out_hw)
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)


def test_grid_pool():
    x = _x((2, 8, 8, 8, 24), seed=8)
    jm = jcoarse.GridPool(24)
    v = jax_variables(jm, jnp.asarray(x), train=False)
    ref = jm.apply(v, jnp.asarray(x), False)
    pm = load_port(GridPool(24), v, ("pool_1",), "pool_1.")
    for g, r in zip(pm(t(x)), ref):
        _close(g, r, 1e-4)


# ---- towers and the joint pipeline at X3D-M, 32², T=8, 7 classes ---------

H, T, TF, NCLS = 32, 8, 8, 7


@pytest.fixture(scope="module")
def joint():
    rng = np.random.RandomState(9)
    clips = rng.rand(2, T, H, H, 3).astype(np.float32)
    fine = rng.rand(2, TF, H, H, 3).astype(np.float32)
    meta = np.asarray([[0, T, TF, 1], [0, T - 2, TF - 3, 1]], np.int32)
    mask = np.ones((2, TF), np.float32)
    mask[1, TF - 3:] = 0
    jm = JPipeline(n_classes=NCLS)
    v = jax_variables(jm, jnp.asarray(clips), jnp.asarray(fine),
                      jnp.asarray(meta), seed=10)
    return jm, v, dict(clips=clips, fine=fine, meta=meta, mask=mask)


def test_from_jax_key_sets_and_strict_load(joint):
    jm, v, _ = joint
    sd = state_dict_from_jax(v)
    for tower, port in (("fine", FineNet()), ("coarse", CoarseNet("M", NCLS))):
        ref_keys = set(export_torch_state_dict(v["params"][tower],
                                               v["batch_stats"][tower]))
        assert set(port.state_dict()) == ref_keys
        port.load_state_dict({k[len(tower) + 1:]: x for k, x in sd.items()
                              if k.startswith(tower + ".")}, strict=True)
    pm = CoarseFinePipeline(n_classes=NCLS, device="cpu")
    pm.load_state_dict(sd, strict=True)
    # layouts: conv (O,I,D,H,W), depthwise (C,1,3,3,3), rw/mix Conv1d (O,I,1)
    assert sd["fine.layer1.0.conv2.weight"].shape == (54, 1, 3, 3, 3)
    assert sd["coarse.conv1_s.weight"].shape == (24, 3, 1, 3, 3)
    assert sd["coarse.rw2.fc2.weight"].shape == (24, 24, 1)
    assert sd["coarse.mix2.conv_at.weight"].shape == (24, 360, 1)
    assert sd["coarse.fc2.weight"].shape == (NCLS, 2048)


@pytest.fixture(scope="module")
def port_pipeline(joint):
    _, v, _ = joint
    pm = CoarseFinePipeline(n_classes=NCLS, device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return pm


@pytest.fixture(scope="module")
def jax_feats(joint):
    jm, v, d = joint
    ext = jax.jit(functools.partial(jm.apply, v, method=JPipeline.extract))
    return {k: np.asarray(x) for k, x in ext(jnp.asarray(d["fine"])).items()}


def test_fine_tower_global_banks(joint, port_pipeline, jax_feats):
    """FineNet global tower: five (B, T_f, 7, 7, C) banks.  Tolerance 1e-3:
    26 bottlenecks of f32 rounding, values O(1)."""
    _, _, d = joint
    with torch.inference_mode():
        got = port_pipeline.fine(t(d["fine"]))
    assert set(got) == set(jax_feats)
    for k, ref in jax_feats.items():
        assert ref.shape[2:4] == (7, 7)
        _close(got[k], ref, 1e-3)


def test_coarse_fuse(joint, port_pipeline, jax_feats):
    """CoarseNet (via fuse) on the JAX banks, with a fine-frame mask; the
    32² input runs mix2 by replication (8 >= 7) and mix3-5 pool-first."""
    jm, v, d = joint
    args = (jnp.asarray(d["clips"]),
            {k: jnp.asarray(x) for k, x in jax_feats.items()},
            jnp.asarray(d["mask"]), jnp.asarray(d["meta"]))
    ref = jax.jit(functools.partial(jm.apply, v, method=JPipeline.fuse))(
        *args)
    with torch.inference_mode():
        logits = port_pipeline.coarse(
            t(d["clips"]), {k: t(x) for k, x in jax_feats.items()},
            t(d["mask"]), t(d["meta"]))
        got = port_pipeline.fuse(t(d["clips"]),
                                 {k: t(x) for k, x in jax_feats.items()},
                                 t(d["mask"]), t(d["meta"]))
    assert logits.shape == (2, T, NCLS)
    _close(got, ref, 1e-4)


def test_pipeline_call_with_fine_mask(joint, port_pipeline):
    """extract + fuse end to end with ``fine_mask``, label length 40."""
    jm, v, d = joint
    call = jax.jit(lambda c, f, m, fm: jm.apply(v, c, f, m, 40,
                                                fine_mask=fm))
    ref = call(jnp.asarray(d["clips"]), jnp.asarray(d["fine"]),
               jnp.asarray(d["meta"]), jnp.asarray(d["mask"]))
    with torch.inference_mode():
        got = port_pipeline(t(d["clips"]), t(d["fine"]), t(d["meta"]), 40,
                            fine_mask=t(d["mask"]))
    assert got.shape == (2, 40, NCLS)
    _close(got, ref, 1e-4)
