"""The port's extraction and coarse drivers end to end against the JAX
package's, on one synthetic mini-Charades tree.

X3D-M at full width, cut to 7 classes, a crop of 64, ``frames=8`` (train
clips of 2 frames padded to 4), ``min_frames=10``, videos of 100 frames
(val clips of 10 frames, bucketed to 16), f32 on the CPU, dropout 0, one
loader worker (more interleave the crops' random draws).  Both sides start
from one reference-named ``.pt`` per stream, which the JAX
``load_pretrained`` reads too (``train/common.py:163-176``), made from
numpy-filled JAX variables (``_torch_port_util.jax_variables``).  Both
coarse drivers read the JAX extraction's feature bank, so the driver
comparison does not carry the extraction's rounding.  The JAX drivers
decode with Pillow, as the port does.

Tolerances: features within 1e-4 of the bank's largest magnitude (f32
rounding through 26 bottlenecks); the train losses within 1e-3 at the
first step and 1.5e-2 after, ``tests/test_torch_port_train_trajectory.py``'s
tolerances and reasons (a relu input within a rounding of 0 taking the
other branch, amplified by batch norm over few elements); ``val_map`` and
the CSV's probabilities within 1.5e-2.

The validation runs train their two steps at learning rate 0 (the batch
norms' split statistics still move): after two steps at 0.01 (the fusion
at 0.1) the two sides' parameters differ by up to 17 % of a tensor's
magnitude (``mix2``), grown from a first update whose per-tensor
difference, up to 0.19 of the update, is the same rounding amplification
(the JAX package's own two layouts differ by up to 0.42 per tensor,
``tests/_torch_port_layout_spread.py``), and per-frame probabilities then
differ by up to 0.19.  The trajectory run keeps 0.01 and its val phase is
not compared.

Why 64² and not 32²: at 32² layer4 is 1×1 and its training batch norm
sees 4 elements, so the configuration amplifies the summation order
itself.  The port alone, at 1, 2, 4 and 8 CPU threads, ended step 2 at
0.4956–0.5153 and ``val_map`` at 0.115–0.212 there (the JAX driver: 0.5003
and 0.137–0.149, inside that spread): no tolerance below it can hold.  At
64² the same four runs spread by at most 2.3e-3 (step 2) and 9e-3 (step 3)
in the loss, 3.2e-4 in ``val_map`` and 2.3e-3 in a probability.
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

from coarse_fine_networks_tpu.data import native as jnative
from coarse_fine_networks_tpu.models.coarse import CoarseNet as JCoarse
from coarse_fine_networks_tpu.models.fine import FineNet as JFine
from coarse_fine_networks_tpu.train import coarse_driver as jcoarse
from coarse_fine_networks_tpu.train import extract_driver as jextract
from coarse_fine_networks_tpu.train.config import DriverConfig as JConfig
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.data import native as pnative
from coarse_fine_networks_torch.data.synthetic import generate_mini_charades
from coarse_fine_networks_torch.models.fine import FEAT_KEYS
from coarse_fine_networks_torch.train import coarse_driver, extract_driver
from coarse_fine_networks_torch.train.config import DriverConfig

from _torch_port_util import BANKS, jax_variables

torch.set_num_threads(2)
NCLS = 7
STEP0_TOL, STEP_TOL, VAL_TOL, FEAT_TOL = 1e-3, 1.5e-2, 1.5e-2, 1e-4


def _base(w, **kw):
    base = dict(anno=w["anno"], root=w["frames"], save_dir=w["root"],
                num_classes=NCLS, batch_size=2, val_batch_size=1, frames=8,
                min_frames=10, crop_size_override=64, max_epochs=3,
                train_phases_per_val=1, num_workers=1, ckpt_every=100,
                max_steps=3, pad_t_multiple=4, pad_label_multiple=8,
                resume=False, compute_dtype="float32", dropout=0.0,
                record_trajectory=True, align_corners=False,
                fusion_lr_mult=10.0)
    base.update(kw)
    return base


def _coarse(w, name, **kw):
    return _base(w, kinetics_ckpt=w["coarse_pt"], fine_feat_dir=w["feats_j"],
                 save_dir=os.path.join(w["root"], name),
                 localize_csv=os.path.join(w["root"], name + ".csv"), **kw)


# the trajectory, then validation by chunked eval and by three crops
RUNS = {"trajectory": dict(t_lim_inference=4),
        "chunked": dict(t_lim_inference=4, init_lr=0.0),
        "crops3": dict(crops=3, init_lr=0.0)}
VAL_RUNS = ("chunked", "crops3")


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
    """The tree (8 videos: 4 train, 4 test) and the two ``.pt`` files."""
    root = str(tmp_path_factory.mktemp("driver"))
    anno = generate_mini_charades(root, num_videos=8, num_frames=100, hw=48,
                                  num_classes=NCLS)
    clips = np.zeros((1, 8, 64, 64, 3), np.float32)
    fine = jax_variables(JFine(version="M", n_classes=NCLS,
                               global_tower=True), clips, seed=1,
                         train=False)
    coarse = jax_variables(
        JCoarse(version="M", n_classes=NCLS, dropout_rate=0.0), clips,
        {k: np.zeros((1, 4, 7, 7, c), np.float32) for k, c in BANKS},
        np.ones((1, 4), np.float32), np.array([[0, 8, 4, 1]], np.int32),
        seed=2, train=False)
    w = {"root": root, "anno": anno, "frames": os.path.join(root, "frames"),
         "fine_pt": os.path.join(root, "fine_ref.pt"),
         "coarse_pt": os.path.join(root, "coarse_ref.pt"),
         "feats_j": os.path.join(root, "feats_jax"),
         "feats_p": os.path.join(root, "feats_port")}
    torch.save({"model_state_dict": state_dict_from_jax(fine)}, w["fine_pt"])
    torch.save({"model_state_dict": state_dict_from_jax(coarse)},
               w["coarse_pt"])
    return w


@pytest.fixture(scope="module")
def jax_runs(world):
    """The JAX extraction and the two coarse runs (compiled once each),
    decoding with Pillow as the port does: the JAX drivers' datasets take
    the native decoder whenever it is built, whose resize differs."""
    w = world
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        n = jextract.run(JConfig(**_base(w)), w["feats_j"], w["fine_pt"])
        return {"extracted": n,
                **{name: jcoarse.run(JConfig(**_coarse(w, "jax_" + name,
                                                       **kw)))
                   for name, kw in RUNS.items()}}


@pytest.fixture(scope="module")
def port_runs(world, jax_runs):
    w = world
    n = extract_driver.run(DriverConfig(**_base(w, device="cpu")),
                           w["feats_p"], w["fine_pt"])
    return {"extracted": n,
            **{name: coarse_driver.run(DriverConfig(**_coarse(
                w, "port_" + name, device="cpu", **kw)))
               for name, kw in RUNS.items()}}


def test_extracted_features_match_jax(world, jax_runs, port_runs):
    assert port_runs["extracted"] == jax_runs["extracted"] == 8
    for k in FEAT_KEYS:
        names = sorted(os.listdir(os.path.join(world["feats_j"], k)))
        assert names == sorted(os.listdir(os.path.join(world["feats_p"],
                                                       k)))
        for name in names:
            ref = np.load(os.path.join(world["feats_j"], k, name))
            got = np.load(os.path.join(world["feats_p"], k, name))
            assert got.dtype == np.float32 and got.shape == ref.shape
            assert got.shape[0] == 10 and got.shape[1:3] == (7, 7)
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert np.isfinite(got).all() and err <= FEAT_TOL, (k, name, err)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_train_losses_match_jax(jax_runs, port_runs, name):
    """The losses of the three steps (at learning rate 0 in the validation
    runs, where only the batches and the split statistics change)."""
    got, ref = port_runs[name]["trajectory"], jax_runs[name]["trajectory"]
    print(name, "port:", got, "\njax: ", ref)
    assert [s for s, _, _ in got] == [s for s, _, _ in ref] == [1, 2, 3]
    assert [lr for _, lr, _ in got] == [lr for _, lr, _ in ref]
    losses, jlosses = [x for *_, x in got], [x for *_, x in ref]
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], jlosses[0], atol=STEP0_TOL)
    np.testing.assert_allclose(losses, jlosses, atol=STEP_TOL)
    assert len(port_runs[name]["step_ms"]) == 3
    assert len(port_runs[name]["prefetch_wait_ms"]) == 3


def _csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return ([(r[0], float(r[1])) for r in rows],
            np.array([[float(x) for x in r[2].split()] for r in rows]))


@pytest.mark.parametrize("name", VAL_RUNS)
def test_validation_matches_jax(world, jax_runs, port_runs, name):
    """``val_map`` and the localize CSV after two steps: by chunked
    long-video eval (windows of 4 frames on clips of 16) and by three-crop
    eval (its max over crops)."""
    got, ref = port_runs[name]["val_map"], jax_runs[name]["val_map"]
    print(name, "val_map port", got, "jax", ref)
    assert np.isfinite(got) and abs(got - ref) <= VAL_TOL
    keys, probs = _csv(os.path.join(world["root"], f"port_{name}.csv"))
    jkeys, jprobs = _csv(os.path.join(world["root"], f"jax_{name}.csv"))
    assert keys == jkeys and len(keys) == 4 * 25
    assert probs.shape == (len(keys), NCLS)
    assert np.abs(probs - jprobs).max() <= VAL_TOL, np.abs(
        probs - jprobs).max()
    assert len(port_runs[name]["val_s"]) == 1


def test_resume_gives_the_uninterrupted_next_loss(world, port_runs):
    """Two steps and a checkpoint at the epoch's end, then a resumed run:
    the third step's loss is the uninterrupted run's."""
    cfg = _coarse(world, "port_resume", device="cpu", **RUNS["trajectory"])
    first = coarse_driver.run(DriverConfig(**dict(cfg, max_steps=2,
                                                  ckpt_every=2)))
    assert [s for s, _, _ in first["trajectory"]] == [1, 2]
    assert "val_map" not in first  # max_steps ends the run in its phase
    resumed = coarse_driver.run(DriverConfig(**dict(cfg, resume=True)))
    assert resumed["resumed_from"] == {"step": 2, "epoch": 0, "pos": 2}
    (step, lr, loss), = resumed["trajectory"]
    ref = port_runs["trajectory"]["trajectory"][2]
    assert (step, lr) == ref[:2]
    assert abs(loss - ref[2]) <= 1e-6, (loss, ref[2])


def test_remat_run_equals_the_plain_run(world, port_runs):
    """``remat=True`` (every bottleneck recomputed in the backward, the
    batch norms' statistics updated once) gives the trajectory run's losses
    and learning rates step for step, exactly: the recomputed forward
    repeats the first on the CPU bit for bit."""
    got = coarse_driver.run(DriverConfig(**_coarse(
        world, "port_remat", device="cpu", remat=True,
        **RUNS["trajectory"])))
    ref = port_runs["trajectory"]
    assert [s for s, _, _ in got["trajectory"]] == [1, 2, 3]
    assert got["trajectory"] == ref["trajectory"]
    assert got.get("val_map") == ref.get("val_map")


@pytest.mark.parametrize("field,value", [("mesh_devices", 2)])
def test_unported_options_raise(world, field, value, request):
    """``mesh_devices=2`` raised until data parallelism was ported; now two
    ranks (spawned over gloo) take the trajectory run's three steps and
    validate on rank 0 (``tests/test_torch_port_dp_driver.py`` holds them
    against one process).  ``pack_dir`` raised until the packs were
    ported: ``test_packed_*`` hold it against the JAX drivers."""
    cfg = DriverConfig(**_coarse(world, "port_unported", device="cpu",
                                 **{field: value}))
    request.getfixturevalue("jax_runs")  # the feature bank it reads
    res = coarse_driver.run(cfg)
    assert [s for s, _, _ in res["trajectory"]] == [1, 2, 3]
    assert np.isfinite([x for _, _, x in res["trajectory"]]).all()
    assert np.isfinite(res["val_map"])


@pytest.fixture(scope="module")
def packed_runs(world, jax_runs):
    """Extraction and a two-step coarse run with ``pack_dir`` on each side,
    each package decoding natively (the JAX library in its exact mode),
    the port's packs of every video but one, which reads its JPEG files;
    both coarse runs read the JAX bank of this extraction."""
    w = world
    packs = os.path.join(w["root"], "packs")
    vids = sorted(os.listdir(w["frames"]))
    assert pnative.pack_directory(w["frames"], packs, vids=vids[1:]) == 7
    feats = {k: os.path.join(w["root"], f"feats_packed_{k}")
             for k in ("jax", "port")}
    kw = dict(pack_dir=packs, max_steps=2, **RUNS["trajectory"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", _JAX_AVAILABLE)
        mp.setattr(pnative, "available", lambda: True)
        prev = (jnative.set_fast_decode(False),
                pnative.set_fast_decode(False))
        try:
            out = {"jax_n": jextract.run(JConfig(**_base(w, pack_dir=packs)),
                                         feats["jax"], w["fine_pt"]),
                   "port_n": extract_driver.run(DriverConfig(**_base(
                       w, pack_dir=packs, device="cpu")), feats["port"],
                       w["fine_pt"])}
            out["jax"] = jcoarse.run(JConfig(**dict(_coarse(
                w, "jax_packed", **kw), fine_feat_dir=feats["jax"])))
            out["port"] = coarse_driver.run(DriverConfig(**dict(_coarse(
                w, "port_packed", device="cpu", **kw),
                fine_feat_dir=feats["jax"])))
        finally:
            jnative.set_fast_decode(prev[0])
            pnative.set_fast_decode(prev[1])
    out["feats"] = feats
    return out


def test_packed_extraction_matches_jax(packed_runs):
    """Features extracted from the packs by both packages' native
    decoders, within the Pillow runs' tolerance; the native decode changes
    the features (the JAX library's resize is not Pillow's)."""
    r = packed_runs
    assert r["port_n"] == r["jax_n"] == 8
    moved = 0.0
    for k in FEAT_KEYS:
        for name in sorted(os.listdir(os.path.join(r["feats"]["jax"], k))):
            ref = np.load(os.path.join(r["feats"]["jax"], k, name))
            got = np.load(os.path.join(r["feats"]["port"], k, name))
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert np.isfinite(got).all() and err <= FEAT_TOL, (k, name, err)
            pil = np.load(os.path.join(os.path.dirname(r["feats"]["jax"]),
                                       "feats_jax", k, name))
            moved = max(moved, np.abs(pil - ref).max() / np.abs(ref).max())
    assert moved > 10 * FEAT_TOL, moved


def test_packed_coarse_run_matches_jax(packed_runs):
    """The two steps' losses and the validation from the packs."""
    got, ref = (packed_runs[k]["trajectory"] for k in ("port", "jax"))
    print("packed port:", got, "\njax: ", ref)
    assert [s for s, _, _ in got] == [s for s, _, _ in ref] == [1, 2]
    losses, jlosses = [x for *_, x in got], [x for *_, x in ref]
    np.testing.assert_allclose(losses[0], jlosses[0], atol=STEP0_TOL)
    np.testing.assert_allclose(losses, jlosses, atol=STEP_TOL)


def test_card_without_a_card_fails(world, monkeypatch):
    """``device="cuda"`` on a machine without a card raises and does not
    run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DriverConfig(**_coarse(world, "port_nocard"))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coarse_driver.run(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_driver.run(dataclasses.replace(cfg), world["feats_p"])
    assert not os.path.exists(os.path.join(world["root"], "port_nocard"))
