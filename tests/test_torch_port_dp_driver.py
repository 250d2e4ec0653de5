"""``coarse_driver.run`` with ``mesh_devices = 2`` on a synthetic
mini-Charades tree: 2 ranks spawned by the driver itself over gloo on the
CPU, each loading its row of every global batch.

X3D-M at full width, 7 classes, a crop of 64, ``frames=8``, a global batch
of 2 (one row a rank), f32, dropout 0, one loader worker, a checkpoint
every step; 4 training videos make an epoch of 2 steps, and validation
(with the localize CSV) runs on rank 0 after each epoch.  The features
come from the port's ``extract_driver`` with a seeded fine stream.

Checked: the checkpoints are written once a step, by rank 0 alone (one
file a step, each carrying both ranks' loader positions, no temporary
file left, and one CSV); a 2-rank run resumed from the step-2 checkpoint
takes step 3 with the uninterrupted 2-rank run's loss (1e-6 relative: the
same ranks, weights, optimizer state, loader positions and random state);
and the validation mAP of the 2-rank run equals the one-process
validation of the checkpoint it validated (1e-6: the same computation on
the same weights, unsharded on rank 0)."""

import csv
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from coarse_fine_networks_torch.ckpt import load_checkpoint
from coarse_fine_networks_torch.data.synthetic import generate_mini_charades
from coarse_fine_networks_torch.metrics import APMeter
from coarse_fine_networks_torch.models import (CoarseNet, FineNet,
                                               init_parameters)
from coarse_fine_networks_torch.train import coarse_driver, extract_driver
from coarse_fine_networks_torch.train.config import DriverConfig
from coarse_fine_networks_torch.train.state import TrainState
from coarse_fine_networks_torch.train.steps import make_eval_step

torch.set_num_threads(2)
NCLS = 7
PREFIX = coarse_driver.PREFIX


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_driver"))
    anno = generate_mini_charades(root, num_videos=8, num_frames=100, hw=48,
                                  num_classes=NCLS)
    fine_pt = os.path.join(root, "fine.pt")
    torch.save({"model_state_dict": init_parameters(
        FineNet("M", NCLS), torch.Generator().manual_seed(1)).state_dict()},
        fine_pt)
    cfg = DriverConfig(
        anno=anno, root=os.path.join(root, "frames"), save_dir=root,
        num_classes=NCLS, batch_size=2, val_batch_size=1, frames=8,
        min_frames=10, crop_size_override=64, max_epochs=3,
        train_phases_per_val=1, num_workers=1, ckpt_every=1, max_steps=3,
        pad_t_multiple=4, pad_label_multiple=8, resume=False,
        compute_dtype="float32", dropout=0.0, record_trajectory=True,
        align_corners=False, fusion_lr_mult=10.0, device="cpu",
        mesh_devices=2)
    feats = os.path.join(root, "feats")
    extract_driver.run(dataclasses.replace(cfg, mesh_devices=None), feats,
                       fine_pt)
    return dataclasses.replace(cfg, fine_feat_dir=feats)


def _cfg(world, name, **kw):
    d = os.path.join(world.save_dir, name)
    return dataclasses.replace(world, save_dir=d,
                               localize_csv=os.path.join(d, "loc.csv"), **kw)


@pytest.fixture(scope="module")
def uninterrupted(world):
    cfg = _cfg(world, "full")
    return cfg, coarse_driver.run(cfg)


def test_rank_zero_writes_each_checkpoint_once(uninterrupted):
    cfg, res = uninterrupted
    files = sorted(os.listdir(cfg.save_dir))
    assert files == [f"{PREFIX}_{s:06d}.ckpt"
                     for s in (1, 2, 3)] + ["loc.csv"], files
    assert [s for s, _, _ in res["trajectory"]] == [1, 2, 3]
    assert np.isfinite([x for _, _, x in res["trajectory"]]).all()
    for s in (1, 2, 3):
        raw = load_checkpoint(os.path.join(cfg.save_dir,
                                           f"{PREFIX}_{s:06d}.ckpt"))
        assert raw["step"] == s
        ranks = raw["rank_loaders"]
        assert len(ranks) == 2 and raw["loader"] == ranks[0]
        assert ranks[0]["pos"] == ranks[1]["pos"]
        assert ranks[0]["epoch"] == ranks[1]["epoch"]
    with open(cfg.localize_csv) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 4 * 25 and {len(r[2].split()) for r in rows} == {NCLS}


def test_resume_takes_the_uninterrupted_step(world, uninterrupted):
    """The uninterrupted run's step-2 checkpoint alone in a directory: a
    2-rank run resumed from it takes step 3 with the uninterrupted loss."""
    full_cfg, full = uninterrupted
    cfg = _cfg(world, "resumed", max_steps=3, resume=True)
    os.makedirs(cfg.save_dir)
    name = f"{PREFIX}_{2:06d}.ckpt"
    shutil.copy(os.path.join(full_cfg.save_dir, name),
                os.path.join(cfg.save_dir, name))
    res = coarse_driver.run(cfg)
    assert res["resumed_from"]["step"] == 2
    assert [s for s, _, _ in res["trajectory"]] == [3]
    np.testing.assert_allclose(res["trajectory"][0][2],
                               full["trajectory"][2][2], rtol=1e-6)


def test_val_map_equals_one_process_eval_of_the_checkpoint(uninterrupted):
    """The 2-rank run validated after step 2 (the end of epoch 1): the
    one-process validation of its step-2 checkpoint gives the same mAP."""
    cfg, res = uninterrupted
    model = CoarseNet(cfg.x3d_version, NCLS, dropout_rate=0.0)
    raw = load_checkpoint(os.path.join(cfg.save_dir,
                                       f"{PREFIX}_{2:06d}.ckpt"))
    model.load_state_dict(raw["variables"], strict=True)
    _, val_loader = coarse_driver.build_coarse_loaders(cfg)
    one = coarse_driver._validate(
        dataclasses.replace(cfg, localize_csv=None), TrainState.create(model),
        model, val_loader, make_eval_step(model, align_corners=False),
        APMeter(), torch.device("cpu"), torch.float32)
    assert np.isfinite(res["val_map"])
    np.testing.assert_allclose(res["val_map"], one, rtol=1e-6)
