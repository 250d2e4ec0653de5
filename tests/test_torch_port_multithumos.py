"""The port's Multi-THUMOS adapter and the temporal and target transforms
against the JAX package's on the same inputs (exact: the same files, the
same ``random`` draws)."""

import json
import os
import random

import numpy as np
import pytest

from coarse_fine_networks_tpu.data import make_dataset as jmake_dataset
from coarse_fine_networks_tpu.data import multithumos as jmt
from coarse_fine_networks_tpu.data import target_transforms as jtt
from coarse_fine_networks_tpu.data import temporal_transforms as jtemp
from coarse_fine_networks_torch.data import make_dataset
from coarse_fine_networks_torch.data import multithumos as pmt
from coarse_fine_networks_torch.data import target_transforms as ptt
from coarse_fine_networks_torch.data import temporal_transforms as ptemp
from coarse_fine_networks_torch.data.synthetic import generate_mini_charades


@pytest.fixture(scope="module")
def thumos(tmp_path_factory):
    """Three videos renamed to THUMOS ids (two validation, one test; one of
    them without annotations), a class list with 65 classes and per-class
    files with a malformed line and a video without frames."""
    root = tmp_path_factory.mktemp("thumos")
    generate_mini_charades(str(root), num_videos=3, num_frames=30, hw=24)
    frames = os.path.join(str(root), "frames")
    names = ["video_validation_0001", "video_validation_0002",
             "video_test_0001"]
    for v, name in enumerate(names):
        os.rename(os.path.join(frames, f"SYN{v:03d}"),
                  os.path.join(frames, name))
    classes = [f"Class{i}" for i in range(pmt.NUM_CLASSES)]
    (root / "class_list.txt").write_text(
        "".join(f"{i + 1} {c}\n" for i, c in enumerate(classes)) + "\n")
    annos = root / "annos"
    annos.mkdir()
    (annos / "Class0.txt").write_text(
        "video_validation_0001 0.1 0.5\nvideo_test_0001 0.2 0.8\nbad\n")
    (annos / "Class7.txt").write_text(
        "video_validation_0001 0.4 0.9\nvideo_validation_0099 0.0 1.0\n")
    (annos / "Class64.txt").write_text("video_test_0001 0.0 0.3\n")
    return {"root": str(root), "frames": frames,
            "classes": str(root / "class_list.txt"), "annos": str(annos)}


def test_load_class_list_matches_jax(thumos):
    got = pmt.load_class_list(thumos["classes"])
    assert got == jmt.load_class_list(thumos["classes"])
    assert len(got) == pmt.NUM_CLASSES == jmt.NUM_CLASSES == 65
    assert got["Class0"] == 0 and got["Class64"] == 64


@pytest.mark.parametrize("durations", [None, {"video_test_0001": 7.5}])
def test_convert_annotations_matches_jax(thumos, tmp_path, durations):
    """The same json, byte for byte, which the port's annotation table
    reads as the JAX one does at 65 classes."""
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    kw = dict(fps=30.0, durations=durations)
    assert pmt.convert_annotations(thumos["annos"], thumos["classes"],
                                   thumos["frames"], mine, **kw) == mine
    jmt.convert_annotations(thumos["annos"], thumos["classes"],
                            thumos["frames"], theirs, **kw)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    with open(mine) as f:
        data = json.load(f)
    assert sorted(data) == ["video_test_0001", "video_validation_0001"]
    assert data["video_validation_0001"]["subset"] == "training"
    for split in ("training", "testing"):
        got = make_dataset(mine, split, thumos["frames"], num_classes=65,
                           min_frames=5)
        ref = jmake_dataset(theirs, split, thumos["frames"],
                            num_classes=65, min_frames=5, use_cache=False)
        assert len(got) == len(ref) == 1
        (vid, label, dur, nf), (jvid, jlabel, jdur, jnf) = got[0], ref[0]
        assert (vid, dur, nf) == (jvid, jdur, jnf)
        np.testing.assert_array_equal(label, jlabel)
        assert label.shape == (30, 65) and label.sum() > 0


@pytest.mark.parametrize("name,args", [
    ("LoopPadding", (7,)), ("TemporalBeginCrop", (5,)),
    ("TemporalCenterCrop", (6,)), ("TemporalRandomCrop", (4, 2, 1)),
    ("TemporalRandomCrop", (3, 1, 2))])
def test_temporal_transforms_match_jax(name, args):
    """Each transform on short and long index lists (loop padding of a
    short one), the random crop from the same ``random`` state, and the
    multigrid size override."""
    got_t, ref_t = getattr(ptemp, name)(*args), getattr(jtemp, name)(*args)
    for n in (0, 3, 11, 40):
        idx = list(range(1, n + 1))
        for size in (None, 6):
            if size and hasattr(got_t, "randomize_parameters"):
                got_t.randomize_parameters(size)
                ref_t.randomize_parameters(size)
            random.seed(n)
            got = got_t(idx)
            random.seed(n)
            assert got == ref_t(idx), (name, n, size)


def test_target_transforms_match_jax():
    target = {"label": 3, "video_id": "v1"}
    for mod in (ptt, jtt):
        assert mod.ClassLabel()(target) == 3
        assert mod.VideoID()(target) == "v1"
    got = ptt.Compose([ptt.VideoID(), ptt.ClassLabel()])(target)
    assert got == jtt.Compose([jtt.VideoID(), jtt.ClassLabel()])(target)
