"""The port's Kinetics-style pretraining against the JAX package's: the
synthetic corpus, the dataset's samples and the collate (uint8, exactly;
both sides decode with Pillow, or both with their native decoders, the
JAX library in its exact mode), the smoothed
cross-entropy, the class train step, a driver run, and the transfer of
the port's checkpoint into the fine driver.

X3D-M at full width, cut to 7 classes, f32 on the CPU, dropout 0.  The
step runs B8 T8 64² at learning rate 0.001; the driver a crop of 64,
``frames=4`` (clips of 4 frames at stride 5 from videos of 40), B2 over 6
training and 2 validation videos, one loader worker.  Both sides start from one set of
numpy-filled JAX variables (``_torch_port_util.jax_variables``): the JAX
driver's init and the port's ``init_parameters`` are replaced by them.

Tolerances: the cross-entropy within 1e-6 (f32 ``log_softmax``); the
step's losses within 1e-3 at the first step and 1.5e-2 after, as in
``tests/test_torch_port_coarse_driver.py`` (a relu input within a
rounding of 0 taking the other branch, amplified by batch norm over few
elements); the driver's mean train loss within 1.5e-2 and its top-1 on
two videos equal.  The class head's one pooled vector a clip makes that
amplification larger than the detection heads': the first step's
gradients of the port and of the JAX plain layout differ by 4.0 % (L2 over
all parameters), those of the JAX package's own fold4 and plain layouts
by 4.4 %, and at B8 and learning rate 0.001 the third step's loss of the
two JAX layouts by 0.0103, the port's from the plain layout's by 0.0100
(at B4: 0.0057 and 0.029; at learning rate 0.01 the port's step 3 is 0.046
away).
"""

import dataclasses
import filecmp
import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.data import kinetics as jkdata
from coarse_fine_networks_tpu.data import native as jnative
from coarse_fine_networks_tpu.models.fine import FineNet as JFine
from coarse_fine_networks_tpu.train import TrainState as JTrainState
from coarse_fine_networks_tpu.train import fine_driver as jfine
from coarse_fine_networks_tpu.train import kinetics_driver as jkin
from coarse_fine_networks_tpu.train.config import DriverConfig as JConfig
from coarse_fine_networks_torch.ckpt import load_checkpoint, \
    state_dict_from_jax
from coarse_fine_networks_torch.data import kinetics as kdata
from coarse_fine_networks_torch.data import native as pnative
from coarse_fine_networks_torch.data.synthetic import generate_mini_charades
from coarse_fine_networks_torch.models import FineNet, init_parameters
from coarse_fine_networks_torch.train import (TrainState, fine_driver,
                                              kinetics_driver)
from coarse_fine_networks_torch.train.config import DriverConfig

from _torch_port_util import jax_variables

torch.set_num_threads(2)
NCLS = 7
STEP0_TOL, STEP_TOL, CE_TOL = 1e-3, 1.5e-2, 1e-6


_JAX_AVAILABLE = jnative.available


@pytest.fixture(scope="module", autouse=True)
def pillow_on_both_sides():
    """Both packages' datasets decode with Pillow unless a test turns the
    native decoders back on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(pnative, "available", lambda: False)
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's corpus (8 videos of 40 frames at 48², 7 classes: 6
    training, 2 validation) and the JAX package's from the same seed."""
    root = str(tmp_path_factory.mktemp("kinetics"))
    anno = kdata.generate_mini_kinetics(os.path.join(root, "port"),
                                        num_videos=8, num_frames=40, hw=48,
                                        num_classes=NCLS)
    janno = jkdata.generate_mini_kinetics(os.path.join(root, "jax"),
                                          num_videos=8, num_frames=40,
                                          hw=48, num_classes=NCLS)
    return {"root": root, "anno": anno, "janno": janno,
            "frames": os.path.join(root, "port", "frames")}


def test_synthetic_corpus_is_the_jax_packages(corpus):
    with open(corpus["anno"]) as f, open(corpus["janno"]) as g:
        anno = json.load(f)
        assert anno == json.load(g)
    assert sum(v["subset"] == "validation" for v in anno.values()) == 2
    jframes = os.path.join(corpus["root"], "jax", "frames")
    for vid in anno:
        names = sorted(os.listdir(os.path.join(corpus["frames"], vid)))
        assert len(names) == 40
        _, mismatch, errors = filecmp.cmpfiles(
            os.path.join(corpus["frames"], vid), os.path.join(jframes, vid),
            names, shallow=False)
        assert not mismatch and not errors, (vid, mismatch, errors)


def _cfgs(corpus, **kw):
    base = dict(anno=corpus["anno"], root=corpus["frames"], frames=4,
                crop_size_override=64, num_classes=NCLS)
    base.update(kw)
    return DriverConfig(**base), JConfig(**base)


@pytest.mark.parametrize("split", ["training", "validation"])
def test_dataset_samples_and_collate_match_jax(corpus, split, monkeypatch):
    """Each sample (the window, the crop and flip drawn from the global
    ``random`` and the dataset's RNG, uint8 pixels) and the collated batch
    of three, as the JAX dataset gives them."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    cfg, jcfg = _cfgs(corpus)
    pt, jt = (fine_driver.build_transforms(cfg),
              jfine.build_transforms(jcfg))
    i = 0 if split == "training" else 1
    kw = dict(frames=4, gamma_tau=cfg.gamma_tau, crop_size=64)
    ds = kdata.KineticsDataset(corpus["anno"], split, corpus["frames"],
                               spatial_transform=pt[i], **kw)
    jds = jkdata.KineticsDataset(corpus["anno"], split, corpus["frames"],
                                 spatial_transform=jt[i], **kw)
    assert ds.data == jds.data and len(ds) == (6 if i == 0 else 2)
    samples = []
    for ds_ in (ds, jds):
        random.seed(5)
        samples.append([ds_[j] for j in range(len(ds_))
                        for _ in range(2)])
    for got, ref in zip(*samples):
        assert got["clips"].dtype == np.uint8
        assert got["clips"].shape == ref["clips"].shape == (1, 4, 64, 64, 3)
        np.testing.assert_array_equal(got["clips"], ref["clips"])
        assert (got["label"], got["vid"], got["flip"]) == (
            ref["label"], ref["vid"], ref["flip"])
    if i == 0:
        assert len({s["flip"] for s in samples[0]}) == 2  # flips drawn
    got = kdata.collate_kinetics(samples[0][:3], pad_t_multiple=16)
    ref = jkdata.collate_kinetics(samples[1][:3], pad_t_multiple=16)
    assert got.keys() == ref.keys()
    for k in ("clips", "clip_mask", "labels", "flip"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["vids"] == ref["vids"]
    assert got["clips"].shape[2] == 16 and got["clip_mask"].sum() == 12


@pytest.mark.parametrize("split", ["training", "validation"])
def test_native_dataset_matches_jax(corpus, split, monkeypatch):
    """With ``decode_backend="native"`` on both sides (the JAX library in
    its exact mode, the port on the CPU): the same windows, crops and
    flips, and the same uint8 pixels."""
    monkeypatch.setattr(jnative, "available", _JAX_AVAILABLE)
    monkeypatch.setattr(pnative, "available", lambda: True)
    prev = jnative.set_fast_decode(False), pnative.set_fast_decode(False)
    try:
        cfg, jcfg = _cfgs(corpus)
        i = 0 if split == "training" else 1
        pt, jt = (fine_driver.build_transforms(cfg)[i],
                  jfine.build_transforms(jcfg)[i])
        kw = dict(frames=4, gamma_tau=cfg.gamma_tau, crop_size=64,
                  decode_backend="native")
        ds = kdata.KineticsDataset(corpus["anno"], split, corpus["frames"],
                                   spatial_transform=pt, device="cpu", **kw)
        jds = jkdata.KineticsDataset(corpus["anno"], split,
                                     corpus["frames"], spatial_transform=jt,
                                     **kw)
        assert (ds.native_train is None) == (jds.native_train is None)
        assert (ds.native_crop, jds.native_crop) == ((None, None) if i == 0
                                                     else (64, 64))
        samples = []
        for ds_ in (ds, jds):
            random.seed(5)
            samples.append([ds_[j] for j in range(len(ds_))
                            for _ in range(2)])
    finally:
        jnative.set_fast_decode(prev[0])
        pnative.set_fast_decode(prev[1])
    for got, ref in zip(*samples):
        assert isinstance(got["clips"], np.ndarray)
        assert got["clips"].shape == ref["clips"].shape == (1, 4, 64, 64, 3)
        np.testing.assert_array_equal(got["clips"], ref["clips"])
        assert (got["label"], got["vid"], got["flip"]) == (
            ref["label"], ref["vid"], ref["flip"])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_smoothed_ce_matches_jax(smoothing):
    rng = np.random.RandomState(3)
    logits = (rng.randn(6, 400) * 4).astype(np.float32)
    labels = rng.randint(0, 400, size=6).astype(np.int32)
    got = kinetics_driver.smoothed_ce(torch.from_numpy(logits),
                                      torch.from_numpy(labels), smoothing)
    ref = jkin.smoothed_ce(jnp.asarray(logits), jnp.asarray(labels),
                           smoothing)
    assert got.dtype == torch.float32 and got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=CE_TOL,
                               rtol=CE_TOL)


def _class_models(seed=1):
    jm = JFine(version="M", n_classes=NCLS, task="class", dropout_rate=0.0)
    v = jax_variables(jm, jnp.zeros((1, 8, 64, 64, 3)), seed=seed,
                      train=False)
    pm = FineNet("M", NCLS, task="class", dropout_rate=0.0,
                 global_tower=False)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm


def test_class_train_step_matches_jax():
    """Three steps of the class step (label smoothing 0.1, lr 0.001, a new
    batch each): the loss and top-1 of each; then the eval step's."""
    jm, v, pm = _class_models()
    jstep = jkin.make_class_train_step(jm, momentum=0.9, weight_decay=1e-5,
                                       label_smoothing=0.1)
    step = kinetics_driver.make_class_train_step(
        pm, momentum=0.9, weight_decay=1e-5, label_smoothing=0.1)
    js, state = JTrainState.create(v), TrainState.create(pm)
    losses, jlosses = [], []
    for i in range(3):
        rng = np.random.RandomState(20 + i)
        batch = {"clips": rng.rand(8, 8, 64, 64, 3).astype(np.float32),
                 "labels": rng.randint(0, NCLS, size=8).astype(np.int32)}
        js, jmet = jstep(js, jax.tree.map(jnp.asarray, batch),
                         jnp.float32(0.001), jax.random.PRNGKey(0))
        state, met = step(state, {k: torch.from_numpy(x)
                                  for k, x in batch.items()}, 0.001)
        losses.append(met["loss"].item())
        jlosses.append(float(jmet["loss"]))
        assert met["acc"].item() == pytest.approx(float(jmet["acc"]))
    print("port:", losses, "\njax: ", jlosses)
    assert state.step == 3 and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], jlosses[0], atol=STEP0_TOL)
    np.testing.assert_allclose(losses, jlosses, atol=STEP_TOL)
    ev = kinetics_driver.make_class_eval_step(pm)(
        state, {k: torch.from_numpy(x) for k, x in batch.items()})
    assert pm.training  # the eval step restores the mode
    assert np.isfinite(ev["loss"].item())


class _Seeded:
    """The JAX ``FineNet`` whose ``init`` returns given variables."""

    def __init__(self, module, variables):
        self._module, self._variables = module, variables

    def init(self, *args, **kwargs):
        return self._variables

    def __getattr__(self, name):
        return getattr(self._module, name)


def _driver_kw(corpus):
    return dict(anno=corpus["anno"], root=corpus["frames"], frames=4,
                crop_size_override=64, num_classes=NCLS, batch_size=2,
                max_epochs=1, num_workers=1, dropout=0.0,
                compute_dtype="float32", label_smoothing=0.1,
                pad_t_multiple=4, resume=False)


@pytest.fixture(scope="module")
def driver_runs(corpus, tmp_path_factory):
    """One epoch (3 steps at lr 0.01, label smoothing 0.1) and a
    validation on each side, from the same weights."""
    _, v, _ = _class_models(seed=2)
    sd = state_dict_from_jax(v)
    root = str(tmp_path_factory.mktemp("kinetics_runs"))
    kw = _driver_kw(corpus)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(jkin, "FineNet",
                   lambda **k: _Seeded(JFine(**k), v))
        random.seed(0)  # the JAX driver leaves `random` unseeded
        ref = jkin.run(JConfig(**kw, save_dir=os.path.join(root, "jax")))
        mp.setattr(kinetics_driver, "init_parameters",
                   lambda m, g: m.load_state_dict(sd, strict=True))
        got = kinetics_driver.run(DriverConfig(
            **kw, save_dir=os.path.join(root, "port"), device="cpu",
            record_trajectory=True))
    return {"root": root, "port": got, "jax": ref}


def test_driver_matches_jax(driver_runs):
    got, ref = driver_runs["port"], driver_runs["jax"]
    print("port", {k: got[k] for k in ("train_loss", "train_top1",
                                       "val_top1", "trajectory")},
          "\njax", ref)
    assert [s for s, _, _ in got["trajectory"]] == [1, 2, 3]
    assert abs(got["train_loss"] - ref["train_loss"]) <= STEP_TOL
    assert got["val_top1"] == ref["val_top1"]
    assert len(got["step_ms"]) == len(got["prefetch_wait_ms"]) == 3
    assert len(got["val_s"]) == 1
    # the last checkpoint, the Kinetics checkpoint of the detection drivers
    assert os.listdir(os.path.join(driver_runs["root"], "port")) == [
        "kinetics_x3d_000003.ckpt"]


def test_remat_run_equals_the_plain_run(corpus, driver_runs, tmp_path):
    """``remat=True`` gives the port's driver run of ``driver_runs`` (the
    same weights and batches) exactly: its losses step for step and its
    top-1; the recomputed forward repeats the first on the CPU bit for
    bit."""
    _, v, _ = _class_models(seed=2)
    sd = state_dict_from_jax(v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kinetics_driver, "init_parameters",
                   lambda m, g: m.load_state_dict(sd, strict=True))
        got = kinetics_driver.run(DriverConfig(
            **_driver_kw(corpus), save_dir=str(tmp_path), device="cpu",
            record_trajectory=True, remat=True))
    ref = driver_runs["port"]
    assert [s for s, _, _ in got["trajectory"]] == [1, 2, 3]
    assert got["trajectory"] == ref["trajectory"]
    assert (got["train_loss"], got["val_top1"]) == (ref["train_loss"],
                                                    ref["val_top1"])


def test_multigrid_and_resume(corpus, tmp_path):
    """The long cycle through pretraining (the dataset's ``frames`` the
    clip's true length), and a run resumed from the checkpoint inside phase
    C's epoch (two splits) continuing there with the uninterrupted
    losses."""
    kw = dict(anno=corpus["anno"], root=corpus["frames"], frames=8,
              crop_size_override=64, num_classes=NCLS, batch_size=1,
              max_epochs=3, num_workers=1, dropout=0.0,
              compute_dtype="float32", pad_t_multiple=4, multigrid=True,
              ckpt_every=1, record_trajectory=True, device="cpu",
              resume=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kinetics_driver.LongCycleSchedule, "__init__",
                   _phases_b_c_d)
        ref = kinetics_driver.run(DriverConfig(**kw, save_dir=str(
            tmp_path / "full")))
        assert ref["multigrid_phases"] == [(0, 4, 32, 4, 4),
                                           (1, 4, 64, 2, 2),
                                           (2, 8, 64, 1, 1)]
        steps = [s for s, _, _ in ref["trajectory"]]
        assert steps == list(range(1, 1 + 1 + 3 + 6))
        os.makedirs(tmp_path / "resumed")
        os.replace(tmp_path / "full" / "kinetics_x3d_000003.ckpt",
                   tmp_path / "resumed" / "kinetics_x3d_000003.ckpt")
        got = kinetics_driver.run(DriverConfig(
            **dict(kw, resume=True), save_dir=str(tmp_path / "resumed")))
    assert got["resumed_from"] == {"step": 3, "epoch": 1, "pos": 2}
    assert got["multigrid_phases"] == ref["multigrid_phases"][1:]
    assert [s for s, _, _ in got["trajectory"]] == steps[3:]
    for (s, _, loss), (s_ref, _, loss_ref) in zip(got["trajectory"],
                                                  ref["trajectory"][3:]):
        assert abs(loss - loss_ref) <= 1e-6, (s, loss, loss_ref)
    assert got["val_top1"] == ref["val_top1"]


def _phases_b_c_d(self, base_frames, base_crop, base_batch,
                  epochs_per_phase=1, phases=None):
    """The default cycle without phase A, whose batch of 8 exceeds the six
    training videos."""
    from coarse_fine_networks_torch.train import multigrid

    self.base = (base_frames, base_crop, base_batch)
    self.phases = multigrid.DEFAULT_LONG_CYCLE[1:]
    self.epochs_per_phase = epochs_per_phase


def test_checkpoint_transfers_to_the_fine_driver(tmp_path):
    """A 400-class pretraining checkpoint restores into the fine driver
    (157 classes): every trunk tensor and ``fc1`` from the checkpoint,
    ``fc2`` the fresh init (the 400 → 157 head swap)."""
    kin = kdata.generate_mini_kinetics(str(tmp_path / "kin"), num_videos=4,
                                       num_frames=24, hw=48, num_classes=400)
    pre = kinetics_driver.run(DriverConfig(
        anno=kin, root=str(tmp_path / "kin" / "frames"), frames=4,
        crop_size_override=64, num_classes=400, batch_size=3, max_steps=1,
        num_workers=1, compute_dtype="float32", dropout=0.0,
        save_dir=str(tmp_path / "pre"), resume=False, device="cpu"))
    assert "train_loss" in pre
    kin_ckpt = str(tmp_path / "pre" / "kinetics_x3d_000001.ckpt")
    src = load_checkpoint(kin_ckpt)["variables"]
    assert src["fc2.weight"].shape == (400, 2048)

    anno = generate_mini_charades(str(tmp_path / "cha"), num_videos=4,
                                  num_frames=60, hw=48)
    fine_driver.run(DriverConfig(
        anno=anno, root=str(tmp_path / "cha" / "frames"), batch_size=2,
        frames=8, min_frames=10, crop_size_override=64, init_lr=0.0,
        max_steps=1, ckpt_every=1, num_workers=1, compute_dtype="float32",
        dropout=0.0, pad_t_multiple=4, pad_label_multiple=8,
        kinetics_ckpt=kin_ckpt, save_dir=str(tmp_path / "fine"),
        resume=False, device="cpu"))
    got = load_checkpoint(str(tmp_path / "fine" /
                              "fine_charades_000001.ckpt"))["variables"]
    fresh = init_parameters(
        FineNet("M", 157, task="loc", global_tower=False),
        torch.Generator().manual_seed(0)).state_dict()
    params = {k for k, _ in FineNet("M", 157, global_tower=False)
              .named_parameters()}
    assert got["fc2.weight"].shape == (157, 2048)
    for k in params:  # learning rate 0: the parameters as restored
        want = fresh[k] if k.startswith("fc2.") else src[k]
        assert torch.equal(got[k], want), k
    assert not torch.equal(got["fc1.weight"], fresh["fc1.weight"])


def test_unported_options_raise(corpus, tmp_path):
    """``mesh_devices=2`` raised until data parallelism was ported; now two
    ranks (spawned over gloo, one row each) train the epoch's three steps
    with label smoothing, validate on rank 0 and rank 0 writes the last
    checkpoint."""
    for field, value in (("mesh_devices", 2),):
        cfg = DriverConfig(**_driver_kw(corpus), save_dir=str(tmp_path),
                           device="cpu", record_trajectory=True,
                           **{field: value})
        res = kinetics_driver.run(dataclasses.replace(cfg))
        assert [s for s, _, _ in res["trajectory"]] == [1, 2, 3]
        assert np.isfinite([x for _, _, x in res["trajectory"]]).all()
        assert 0.0 <= res["val_top1"] <= 1.0
        assert os.listdir(tmp_path) == ["kinetics_x3d_000003.ckpt"]