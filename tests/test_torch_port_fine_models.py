"""The port's fine-stream model pieces against the JAX package, on the CPU
in f32: ``FineNet``'s logits heads and ``extract_feat`` (X3D-M at full
width, 7 classes, B=2, T=4, 32²), the ``from_jax`` keys of its head, model
surgery, the multigrid long-cycle schedule, and the device batch
(``device_normalize``, ``prepare_clips``, ``model_batch``).  Tolerances are
stated per test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.ckpt.torch_convert import export_torch_state_dict
from coarse_fine_networks_tpu.data.transforms import \
    device_normalize as jdevice_normalize
from coarse_fine_networks_tpu.models import surgery as jsurgery
from coarse_fine_networks_tpu.models.fine import FineNet as JFine
from coarse_fine_networks_tpu.train import common as jcommon
from coarse_fine_networks_tpu.train import multigrid as jmultigrid
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.data import device_normalize
from coarse_fine_networks_torch.models import (CoarseNet, FineNet,
                                               SubBatchNorm, replace_logits,
                                               set_bn_splits,
                                               update_bn_splits)
from coarse_fine_networks_torch.train import (DEFAULT_LONG_CYCLE,
                                              LongCycleSchedule, model_batch,
                                              prepare_clips)

from _torch_port_util import close, jax_variables, t

torch.set_num_threads(2)

NCLS = 7


def _clips(seed=0, b=2, tt=4, hw=32):
    return np.random.RandomState(seed).rand(b, tt, hw, hw, 3).astype(
        np.float32)


def _pair(task="loc", extract_feat=False, bn_splits=1, seed=0):
    """JAX ``FineNet`` (plain layout, dropout 0) with variables from a numpy
    seed, and the port's ``FineNet`` loaded with the same weights."""
    jm = JFine(version="M", n_classes=NCLS, task=task, dropout_rate=0.0,
               extract_feat=extract_feat, bn_splits=bn_splits,
               trunk_layout="plain")
    v = jax_variables(jm, jnp.asarray(_clips()), seed=seed, train=False)
    pm = set_bn_splits(FineNet("M", NCLS, task=task, dropout_rate=0.0,
                               extract_feat=extract_feat,
                               global_tower=False), bn_splits)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm


@pytest.mark.parametrize("task,extract_feat", [
    ("loc", False), ("class", False), ("loc", True)])
def test_fine_net_eval_heads(task, extract_feat):
    """Eval: ``loc`` logits ``(B, T, 7)``, ``class`` logits ``(B, 1, 7)``,
    and the pooled head features of ``extract_feat`` ``(B, T, 1, 1, 432)``.
    Tolerance 1e-4 of the output's largest magnitude (26 bottlenecks of f32
    rounding)."""
    jm, v, pm = _pair(task, extract_feat, seed=1)
    x = _clips(2)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), False))
    with torch.no_grad():
        got = pm.eval()(t(x)).numpy()
    want = {("loc", False): (2, 4, NCLS), ("class", False): (2, 1, NCLS),
            ("loc", True): (2, 4, 1, 1, 432)}[task, extract_feat]
    assert got.shape == ref.shape == want
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_fine_net_train_logits_and_split_stats():
    """Training with two batch-norm splits and dropout 0, B=4 at 64² (two
    samples per split): the ``loc`` logits within 1e-3 of their largest
    magnitude, and every new split statistic within 1e-3 of its tensor's
    largest magnitude.  Looser than eval's 1e-4 for a measured reason: at
    layer4 (2×2) each split normalises over 2·4·2·2 = 32 elements, which
    amplifies f32 rounding in another order (3.2e-4 here; 1.2e-3 with one
    split at 32², where it is 8 elements)."""
    jm, v, pm = _pair("loc", bn_splits=2, seed=3)
    x = _clips(4, b=4, hw=64)
    ref, upd = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    got = pm.train()(t(x))
    assert got.shape == (4, 4, NCLS)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-3 * float(jnp.abs(ref).max()))
    new = state_dict_from_jax({"params": v["params"], **upd})
    split = {k: r for k, r in new.items() if "split_bn" in k}
    assert len(split) == 2 * sum(isinstance(m, SubBatchNorm)
                                 for m in pm.modules())
    sd = pm.state_dict()
    for k, r in split.items():
        assert sd[k].shape == r.shape
        assert float((sd[k] - r).abs().max() / r.abs().max()) <= 1e-3, k


def test_fine_net_dropout_draws_from_the_generator():
    """Training with dropout 0.5: the mask comes from the generator passed
    to ``forward`` (same seed, same logits), and none is drawn in eval."""
    pm = FineNet("M", NCLS, dropout_rate=0.5, global_tower=False)
    x = t(_clips(5))
    a = pm.train()(x, generator=torch.Generator().manual_seed(0))
    b = pm(x, generator=torch.Generator().manual_seed(0))
    c = pm(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        pm(x)
    assert pm.eval()(x).shape == (2, 4, NCLS)


@pytest.mark.parametrize("task,extract_feat", [("loc", False),
                                               ("loc", True)])
def test_fine_net_from_jax_keys_and_strict_load(task, extract_feat):
    """The port's ``state_dict`` keys are the JAX converter's torch names,
    ``fc1``/``fc2`` included (none for ``extract_feat``), and the JAX
    variables load strictly; ``fc1`` is a 1×1×1 conv, ``fc2`` a linear."""
    jm, v, pm = _pair(task, extract_feat)
    ref = set(export_torch_state_dict(v["params"], v["batch_stats"]))
    assert set(pm.state_dict()) == ref
    assert ("fc1.weight" in ref) == (not extract_feat)
    if not extract_feat:
        sd = state_dict_from_jax(v)
        assert sd["fc1.weight"].shape == (2048, 432, 1, 1, 1)
        assert sd["fc2.weight"].shape == (NCLS, 2048)
        assert sd["fc2.bias"].shape == (NCLS,)
    assert set(FineNet().state_dict()) == set(FineNet(
        global_tower=True).state_dict())


# ---- surgery and the schedule ------------------------------------------------

def _stats_tree(model):
    """The port model's batch-norm statistics as a JAX ``batch_stats``-like
    tree of numpy leaves, keyed by module name."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, SubBatchNorm):
            out[name] = {"mean": m.bn.running_mean.numpy().copy(),
                         "var": m.bn.running_var.numpy().copy(),
                         "split_mean": m.split_bn.running_mean.numpy().copy(),
                         "split_var": m.split_bn.running_var.numpy().copy()}
    return out


def test_set_bn_splits_through_the_long_cycle_matches_jax():
    """8 → 4 → 2 → 1 on a whole ``FineNet``: every split statistic is the
    JAX function's (fresh zeros and ones at ``n·C``), the eval statistics
    are kept, and every batch norm reads the new split count; then
    ``update_bn_splits`` × 2 against the JAX function.  Exact."""
    pm = FineNet("M", NCLS, global_tower=False)
    with torch.no_grad():
        for m in pm.modules():
            if isinstance(m, SubBatchNorm):
                m.bn.running_mean.normal_()
                m.split_bn.running_var.uniform_(0.5, 1.5)
    jstats = _stats_tree(pm)
    for n in (8, 4, 2, 1):
        jstats = jsurgery.set_bn_splits(jstats, n)
        set_bn_splits(pm, n)
        got = _stats_tree(pm)
        assert got.keys() == jstats.keys()
        for name, node in jstats.items():
            for leaf, ref in node.items():
                np.testing.assert_array_equal(got[name][leaf],
                                              np.asarray(ref))
        assert {m.num_splits for m in pm.modules()
                if isinstance(m, SubBatchNorm)} == {n}
    jstats = jsurgery.update_bn_splits(jstats, 2)
    update_bn_splits(pm, 2)
    for name, node in _stats_tree(pm).items():
        assert node["split_mean"].shape == jstats[name]["split_mean"].shape
        assert pm.get_submodule(name).num_splits == 2


def test_set_bn_splits_keeps_the_optimizer_valid():
    """The split statistics are buffers: an optimizer built before the
    rebuild still holds every parameter and nothing else."""
    pm = FineNet("M", NCLS, global_tower=False)
    opt = torch.optim.SGD(pm.parameters(), lr=0.1, momentum=0.9)
    before = [id(p) for g in opt.param_groups for p in g["params"]]
    set_bn_splits(pm, 4)
    assert before == [id(p) for p in pm.parameters()]


@pytest.mark.parametrize("kind", ["fine", "coarse"])
def test_replace_logits(kind):
    """The new head's shapes are the JAX function's, its init is
    ``nn.Linear``'s default range, it is drawn from the generator, and the
    coarse model's ``rw6`` class heads are rebuilt too."""
    gen = torch.Generator().manual_seed(0)
    if kind == "fine":
        pm = FineNet("M", 400, global_tower=False)
        params = {"fc2": {"kernel": np.zeros((2048, 400)),
                          "bias": np.zeros(400)}}
    else:
        pm = CoarseNet("M", 400)
        params = {"fc2": {"kernel": np.zeros((2048, 400)),
                          "bias": np.zeros(400)},
                  "rw6": {"fc2": {"kernel": np.zeros((432, 400)),
                                  "bias": np.zeros(400)},
                          "fc4": {"kernel": np.zeros((432, 400)),
                                  "bias": np.zeros(400)}}}
    ref = jsurgery.replace_logits(params, NCLS, jax.random.PRNGKey(0), kind)
    replace_logits(pm, NCLS, gen)
    sd = state_dict_from_jax({"params": ref})
    for k, r in sd.items():
        got = pm.state_dict()[k]
        assert got.shape == r.shape, k
        bound = 1 / np.sqrt(r.shape[1] if r.dim() > 1 else
                            pm.state_dict()[k.replace("bias", "weight")]
                            .shape[1])
        assert float(got.abs().max()) <= bound and float(got.std()) > 0
    again = replace_logits(FineNet("M", 400, global_tower=False), NCLS,
                           torch.Generator().manual_seed(0))
    if kind == "fine":
        assert torch.equal(again.fc2.weight, pm.fc2.weight)


def test_long_cycle_transition_is_absolute():
    """Phase transitions set absolute split counts (8 → 4, not 8 → 32), on
    the module."""
    bn = SubBatchNorm(3)
    sched = LongCycleSchedule(8, 32, 2, epochs_per_phase=1)
    assert sched.transition(0, bn) == 8
    assert bn.split_bn.running_mean.shape == (24,)
    assert sched.transition(1, bn) == 4
    assert bn.split_bn.running_mean.shape == (12,)


def test_long_cycle_shapes_match_jax():
    """The fine driver's schedule (frames 320, crop 224, batch 8): every
    phase's (frames, crop, batch) and split count as the JAX schedule gives
    them, and each phase's clip length ``2·frames/10`` (the dataset's
    window over 10-frame steps)."""
    port = LongCycleSchedule(320, 224, 8)
    ref = jmultigrid.LongCycleSchedule(320, 224, 8)
    assert [dataclass_tuple(p) for p in DEFAULT_LONG_CYCLE] == [
        dataclass_tuple(p) for p in jmultigrid.DEFAULT_LONG_CYCLE]
    shapes = [port.shapes(e) for e in range(4)]
    assert shapes == [ref.shapes(e) for e in range(4)]
    assert shapes == [(80, 112, 64), (160, 144, 32), (160, 224, 16),
                      (320, 224, 8)]
    assert [port.phase(e).bn_split_scale for e in range(5)] == [8, 4, 2, 1, 8]


def dataclass_tuple(p):
    return (p.frames_scale, p.crop_scale, p.batch_scale, p.bn_split_scale)


# ---- the device batch ----------------------------------------------------------

def _host_batch(n_crops, seed=0):
    rng = np.random.RandomState(seed)
    b, tt = 2, 6
    clip_mask = np.ones((b, tt), np.float32)
    clip_mask[1, 4:] = 0
    return {
        "clips": rng.randint(0, 256, (b, n_crops, tt, 8, 10, 3)).astype(
            np.uint8),
        "flip": np.array([True, False]),
        "clip_mask": clip_mask,
        "labels": (rng.rand(b, 12, NCLS) > 0.8).astype(np.float32),
        "masks": np.ones((b, 12), np.float32),
    }


def test_device_normalize_matches_jax():
    """ToTensor + Normalize + the per-clip W flip, f32, within 1e-6."""
    hb = _host_batch(1)
    clips = hb["clips"][:, 0]
    ref = jdevice_normalize(jnp.asarray(clips), hb["flip"])
    got = device_normalize(torch.from_numpy(clips), torch.from_numpy(
        hb["flip"]))
    close(got, ref, 1e-6)
    assert torch.equal(got[0], torch.flip(device_normalize(
        torch.from_numpy(clips[:1]), torch.tensor([False]))[0], (2,)))
    assert device_normalize(torch.from_numpy(clips), hb["flip"],
                            out_dtype=torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("n_crops,train", [(1, True), (3, False)])
def test_prepare_clips_and_model_batch_match_jax(n_crops, train):
    """The crops axis (squeezed in training, folded into the batch in eval,
    each crop with its sample's flip) and the padded frames zeroed after
    the normalisation, against the JAX functions within 1e-6; the labels
    and masks pass through."""
    hb = _host_batch(n_crops, seed=n_crops)
    ref = jcommon.model_batch(hb, train)
    got = model_batch(hb, device="cpu")
    assert set(got) == set(ref)
    close(got["clips"], ref["clips"], 1e-6)
    assert got["clips"].shape == (2 * n_crops, 6, 8, 10, 3)
    assert not got["clips"][n_crops:, 4:].any()
    for k in ("labels", "masks"):
        assert torch.equal(got[k], t(ref[k]))
    b16 = prepare_clips(hb, dtype=torch.bfloat16, device="cpu")
    assert b16.dtype == torch.bfloat16
    torch.testing.assert_close(b16, got["clips"].bfloat16(), rtol=0, atol=0)
