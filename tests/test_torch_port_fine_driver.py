"""The port's fine driver end to end against the JAX package's, on one
synthetic mini-Charades tree, and its resume under the long cycle.

X3D-M at full width, cut to 7 classes, a crop of 64, ``frames=8`` (train
clips of 2 frames padded to 4), ``min_frames=10``, videos of 100 frames
(val clips of 10 frames, bucketed to 16), f32 on the CPU, dropout 0, one
loader worker (more interleave the crops' random draws).  Both sides start
from one reference-named ``.pt`` of the fine stream with its logits head,
made from numpy-filled JAX variables (``_torch_port_util.jax_variables``),
which the JAX ``load_pretrained`` reads too.  Both drivers decode with
Pillow (each package's datasets take its native decoder wherever it runs,
and the JAX library's resize differs from Pillow's), except the packed
run: both sides' native decoders in the JAX package's exact mode, from the
port's ``.cfnpack`` packs.

Runs: ``multigrid``, the long cycle with both packages'
``DEFAULT_LONG_CYCLE`` cut to two phases of the base clip (``frames=16``:
4 frames at 64²), an epoch each, B4 at two batch-norm splits then B2 at
one, so that every split normalises two clips; three steps at learning
rate 0.01 across the split change (phase A's crop scale of 0.5 would put
layer4 at 1×1, and one clip a split of 2 frames padded to 4 spread the
two sides' losses by 0.025 by step 3); ``chunked`` and ``crops2``, two
steps at learning rate 0 (only the split statistics move) and a
validation, by windows of 4 frames and by two crops a video (after the
multigrid run's steps at 0.01 the two sides' ``val_map`` differ by 0.022,
the parameters' rounding amplified as in the coarse test).

Tolerances: the losses within 1e-3 at the first step and 1.5e-2 after,
``val_map`` within 1.5e-2: ``tests/test_torch_port_coarse_driver.py``'s
tolerances and reasons (a relu input within a rounding of 0 taking the
other branch, amplified by batch norm over few elements; the JAX
package's own two layouts differ by as much).  The resume tests run the
port alone, with the full four-phase cycle, and hold the resumed run's
losses and ``val_map`` to the uninterrupted run's within 1e-6.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from coarse_fine_networks_tpu.data import native as jnative
from coarse_fine_networks_tpu.models.fine import FineNet as JFine
from coarse_fine_networks_tpu.train import fine_driver as jfine
from coarse_fine_networks_tpu.train import multigrid as jmultigrid
from coarse_fine_networks_tpu.train.config import DriverConfig as JConfig
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.data import native as pnative
from coarse_fine_networks_torch.data.synthetic import generate_mini_charades
from coarse_fine_networks_torch.train import fine_driver, multigrid
from coarse_fine_networks_torch.train.config import DriverConfig

from _torch_port_util import jax_variables

torch.set_num_threads(2)
NCLS = 7
STEP0_TOL, STEP_TOL, VAL_TOL, RESUME_TOL = 1e-3, 1.5e-2, 1.5e-2, 1e-6


def _base(w, name, **kw):
    base = dict(anno=w["anno"], root=w["frames"],
                save_dir=os.path.join(w["root"], name), num_classes=NCLS,
                batch_size=2, val_batch_size=1, frames=8, min_frames=10,
                crop_size_override=64, max_epochs=1, train_phases_per_val=1,
                num_workers=1, ckpt_every=100, pad_t_multiple=4,
                pad_label_multiple=8, resume=False, compute_dtype="float32",
                dropout=0.0, record_trajectory=True,
                kinetics_ckpt=w["fine_pt"])
    base.update(kw)
    return base


# the long cycle across a split change, then validation by chunked eval
# and by two crops after steps at learning rate 0
RUNS = {"multigrid": dict(multigrid=True, frames=16, max_epochs=2,
                          train_phases_per_val=2, max_steps=3),
        "chunked": dict(t_lim_inference=4, init_lr=0.0),
        "crops2": dict(crops=2, init_lr=0.0)}
VAL_RUNS = ("chunked", "crops2")


def _two_phases(phase_cls):
    return [phase_cls(1.0, 1.0, 2, 2), phase_cls(1.0, 1.0, 1, 1)]


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
def world(tmp_path_factory):
    """The tree (8 videos: 4 train, 4 test) and the fine stream's ``.pt``."""
    root = str(tmp_path_factory.mktemp("fine_driver"))
    anno = generate_mini_charades(root, num_videos=8, num_frames=100, hw=48,
                                  num_classes=NCLS)
    fine = jax_variables(JFine(version="M", n_classes=NCLS, dropout_rate=0.0),
                         np.zeros((1, 8, 64, 64, 3), np.float32), seed=1,
                         train=False)
    w = {"root": root, "anno": anno, "frames": os.path.join(root, "frames"),
         "fine_pt": os.path.join(root, "fine_ref.pt")}
    torch.save({"model_state_dict": state_dict_from_jax(fine)}, w["fine_pt"])
    return w


@pytest.fixture(scope="module")
def jax_runs(world):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(jmultigrid, "DEFAULT_LONG_CYCLE",
                   _two_phases(jmultigrid.LongCyclePhase))
        return {name: jfine.run(JConfig(**_base(world, "jax_" + name, **kw)))
                for name, kw in RUNS.items()}


@pytest.fixture(scope="module")
def port_runs(world, jax_runs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(multigrid, "DEFAULT_LONG_CYCLE",
                   _two_phases(multigrid.LongCyclePhase))
        return {name: fine_driver.run(DriverConfig(**_base(
            world, "port_" + name, device="cpu", **kw)))
            for name, kw in RUNS.items()}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_train_losses_match_jax(jax_runs, port_runs, name):
    """Every step's loss (at learning rate 0 in the validation runs, where
    only the batches and the split statistics change); in ``multigrid``
    one step at two splits, then two at one."""
    got, ref = port_runs[name]["trajectory"], jax_runs[name]["trajectory"]
    print(name, "port:", got, "\njax: ", ref)
    n = 3 if name == "multigrid" else 2
    assert [s for s, _, _ in got] == [s for s, _, _ in ref] == list(
        range(1, n + 1))
    # the JAX driver records its learning rate as an f32 array
    np.testing.assert_array_equal(np.float32([lr for _, lr, _ in got]),
                                  np.float32([lr for _, lr, _ in ref]))
    losses, jlosses = [x for *_, x in got], [x for *_, x in ref]
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], jlosses[0], atol=STEP0_TOL)
    np.testing.assert_allclose(losses, jlosses, atol=STEP_TOL)
    assert len(port_runs[name]["step_ms"]) == n
    assert len(port_runs[name]["prefetch_wait_ms"]) == n


def test_multigrid_phases_match_jax(jax_runs, port_runs):
    """(epoch, frames, crop, batch, splits) of each phase, exactly."""
    got = port_runs["multigrid"]["multigrid_phases"]
    assert got == jax_runs["multigrid"]["multigrid_phases"]
    assert got == [(0, 16, 64, 4, 2), (1, 16, 64, 2, 1)]
    assert "val_map" not in port_runs["multigrid"]  # max_steps ends it


@pytest.mark.parametrize("name", VAL_RUNS)
def test_validation_matches_jax(jax_runs, port_runs, name):
    """``val_map`` and ``val_loss`` after two steps at learning rate 0: by
    chunked long-video eval (windows of 4 frames on clips of 16) and by
    two-crop eval (the max over the crops' probabilities)."""
    got, ref = port_runs[name], jax_runs[name]
    print(name, "val_map port", got["val_map"], "jax", ref["val_map"],
          "val_loss port", got["val_loss"], "jax", ref["val_loss"])
    assert np.isfinite(got["val_map"])
    assert abs(got["val_map"] - ref["val_map"]) <= VAL_TOL
    assert abs(got["val_loss"] - ref["val_loss"]) <= VAL_TOL * abs(
        ref["val_loss"])
    assert len(got["val_s"]) == 1


# ---- resume under the long cycle (the port alone) --------------------------

@pytest.fixture(scope="module")
def cycle_world(tmp_path_factory):
    """A tree of 12 videos (8 train, 4 test) for the full cycle at base
    batch 1 (B8, B4, B2, B1: 1 + 2 + 4 + 8 steps), and the uninterrupted
    run with a checkpoint every step."""
    root = str(tmp_path_factory.mktemp("fine_cycle"))
    anno = generate_mini_charades(root, num_videos=12, num_frames=100, hw=48,
                                  num_classes=NCLS, train_fraction=8 / 12)
    w = {"root": root, "anno": anno, "frames": os.path.join(root, "frames"),
         "fine_pt": None}
    cfg = _base(w, "uninterrupted", device="cpu", multigrid=True,
                batch_size=1, max_epochs=4, train_phases_per_val=4,
                ckpt_every=1)
    w["cfg"] = cfg
    w["ref"] = fine_driver.run(DriverConfig(**cfg))
    for name in os.listdir(cfg["save_dir"]):  # keep the resume tests' three
        if not name.endswith(("000003.ckpt", "000005.ckpt", "000010.ckpt")):
            os.remove(os.path.join(cfg["save_dir"], name))
    return w


def test_uninterrupted_cycle(cycle_world):
    ref = cycle_world["ref"]
    assert ref["multigrid_phases"] == [
        (0, 2, 32, 8, 8), (1, 4, 32, 4, 4), (2, 4, 64, 2, 2),
        (3, 8, 64, 1, 1)]
    assert [s for s, _, _ in ref["trajectory"]] == list(range(1, 16))
    assert np.isfinite(ref["val_map"]) and len(ref["val_s"]) == 1


# step 3 ends phase B's epoch; 5 lies inside phase C's epoch (2 splits,
# the second of its four batches); 10 inside phase D's
@pytest.mark.parametrize("step,epoch,pos", [(3, 1, 2), (5, 2, 2),
                                            (10, 3, 3)])
def test_resume_in_the_saved_phase(cycle_world, step, epoch, pos):
    """A run resumed from the uninterrupted run's checkpoint at ``step``
    continues in the saved epoch's phase (its split count restored before
    the weights), at the batch after the last one the loop took, with that
    batch's random state: its losses and ``val_map`` are the
    uninterrupted run's."""
    w = cycle_world
    d = os.path.join(w["root"], f"resume_{step}")
    os.makedirs(d)
    shutil.copy(os.path.join(w["root"], "uninterrupted",
                             f"fine_charades_{step:06d}.ckpt"), d)
    got = fine_driver.run(DriverConfig(**dict(w["cfg"], save_dir=d,
                                              resume=True)))
    ref = w["ref"]
    assert got["resumed_from"] == {"step": step, "epoch": epoch, "pos": pos}
    assert got["multigrid_phases"] == ref["multigrid_phases"][epoch:]
    assert [s for s, _, _ in got["trajectory"]] == list(range(step + 1, 16))
    for (s, lr, loss), (s_ref, lr_ref, loss_ref) in zip(
            got["trajectory"], ref["trajectory"][step:]):
        assert (s, lr) == (s_ref, lr_ref)
        assert abs(loss - loss_ref) <= RESUME_TOL, (s, loss, loss_ref)
    assert abs(got["val_map"] - ref["val_map"]) <= RESUME_TOL


def test_remat_run_equals_the_plain_run(world, port_runs):
    """``remat=True`` through the long cycle's split change (two splits by
    the split route, then one by the act route) gives the multigrid run's
    losses step for step, exactly: the recomputed forward repeats the first
    on the CPU bit for bit, and the statistics move once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(multigrid, "DEFAULT_LONG_CYCLE",
                   _two_phases(multigrid.LongCyclePhase))
        got = fine_driver.run(DriverConfig(**_base(
            world, "port_remat", device="cpu", remat=True,
            **RUNS["multigrid"])))
    ref = port_runs["multigrid"]
    assert got["multigrid_phases"] == ref["multigrid_phases"]
    assert [s for s, _, _ in got["trajectory"]] == [1, 2, 3]
    assert got["trajectory"] == ref["trajectory"]


@pytest.mark.parametrize("field,value", [("mesh_devices", 2)])
def test_unported_options_raise(world, field, value):
    """``mesh_devices=2`` raised until data parallelism was ported; now two
    ranks (spawned over gloo) train an epoch of two steps, one row each,
    and validate on rank 0.  ``pack_dir`` raised until the packs were
    ported: ``test_packed_run_matches_jax`` holds it against JAX."""
    cfg = DriverConfig(**_base(world, "port_unported", device="cpu",
                               **{field: value}))
    res = fine_driver.run(cfg)
    assert [s for s, _, _ in res["trajectory"]] == [1, 2]
    assert np.isfinite([x for _, _, x in res["trajectory"]]).all()
    assert np.isfinite(res["val_map"]) and np.isfinite(res["val_loss"])


def test_packed_run_matches_jax(world):
    """``pack_dir`` on both sides, each package decoding natively (the JAX
    library in its exact mode) from the port's packs of every video but
    one, which reads its JPEG files: the two steps' losses and the
    validation's ``val_map`` within the Pillow runs' tolerances."""
    packs = os.path.join(world["root"], "packs")
    vids = sorted(os.listdir(world["frames"]))
    assert pnative.pack_directory(world["frames"], packs,
                                  vids=vids[:-1]) == 7
    kw = dict(pack_dir=packs, **RUNS["chunked"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", _JAX_AVAILABLE)
        mp.setattr(pnative, "available", lambda: True)
        prev = (jnative.set_fast_decode(False),
                pnative.set_fast_decode(False))
        try:
            ref = jfine.run(JConfig(**_base(world, "jax_packed", **kw)))
            got = fine_driver.run(DriverConfig(**_base(
                world, "port_packed", device="cpu", **kw)))
        finally:
            jnative.set_fast_decode(prev[0])
            pnative.set_fast_decode(prev[1])
    print("packed port:", got["trajectory"], "\njax: ", ref["trajectory"])
    assert [s for s, _, _ in got["trajectory"]] == [1, 2]
    losses = [x for *_, x in got["trajectory"]]
    jlosses = [x for *_, x in ref["trajectory"]]
    np.testing.assert_allclose(losses[0], jlosses[0], atol=STEP0_TOL)
    np.testing.assert_allclose(losses, jlosses, atol=STEP_TOL)
    assert abs(got["val_map"] - ref["val_map"]) <= VAL_TOL


def test_card_without_a_card_fails(world, monkeypatch):
    """``device="cuda"`` on a machine without a card raises and does not
    run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DriverConfig(**_base(world, "port_nocard"))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fine_driver.run(dataclasses.replace(cfg))
    assert not os.path.exists(os.path.join(world["root"], "port_nocard"))
