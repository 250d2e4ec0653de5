"""The port's metrics against the JAX package's on the same inputs:
``APMeter`` (with and without weights, with ties), ``subsample_25`` and
``evaluate_localization`` within 1e-12, and ``LocalizeCSVWriter``'s bytes
(the same numpy arithmetic on both sides)."""

import json

import numpy as np
import pytest

from coarse_fine_networks_tpu.metrics import ap as jap
from coarse_fine_networks_tpu.metrics import charades_eval as jev
from coarse_fine_networks_tpu.metrics import localize as jloc
from coarse_fine_networks_torch.metrics import ap as pap
from coarse_fine_networks_torch.metrics import charades_eval as pev
from coarse_fine_networks_torch.metrics import localize as ploc


def _chunks(seed, n_chunks=4, k=13, ties=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_chunks):
        n = rng.randint(1, 40)
        s = rng.rand(n, k).astype(np.float32)
        if ties:
            s = np.round(s * 4) / 4
        t = (rng.rand(n, k) > 0.8).astype(np.float32)
        w = rng.rand(n).astype(np.float32)
        out.append((s, t, w))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_apmeter_matches_jax(seed, weights, ties):
    pm, jm = pap.APMeter(), jap.APMeter()
    for s, t, w in _chunks(seed, ties=ties):
        pm.add(s, t, w if weights else None)
        jm.add(s, t, w if weights else None)
    got, ref = pm.value(), jm.value()
    assert got.dtype == ref.dtype and got.shape == ref.shape == (13,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert abs(pm.mean() - jm.mean()) <= 1e-12
    pm.reset()
    assert pm.value().size == 0 and pm.mean() == 0.0


def test_apmeter_one_dimensional_and_bad_input():
    pm, jm = pap.APMeter(), jap.APMeter()
    s = np.linspace(0, 1, 9, dtype=np.float32)
    t = (np.arange(9) % 3 == 0).astype(np.float32)
    pm.add(s, t)
    jm.add(s, t)
    np.testing.assert_allclose(pm.value(), jm.value(), rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        pm.add(s, t * 0.5)  # targets must be binary
    with pytest.raises(ValueError):
        pm.add(s[:4], t)


@pytest.mark.parametrize("valid_t", [1, 7, 24, 25, 26, 49, 50, 77, 640])
def test_subsample_25_matches_jax(valid_t):
    rng = np.random.RandomState(valid_t)
    p = rng.rand(700, 5).astype(np.float32)
    lab = (rng.rand(700, 5) > 0.5).astype(np.float32)
    got, got_l = ploc.subsample_25(p, valid_t, lab)
    ref, ref_l = jloc.subsample_25(p, valid_t, lab)
    assert np.array_equal(got, ref) and np.array_equal(got_l, ref_l)
    assert np.array_equal(ploc.subsample_25(p, valid_t),
                          jloc.subsample_25(p, valid_t))
    assert len(got) <= 25


def _annotations(n_videos=6, k=9, seed=0):
    rng = np.random.RandomState(seed)
    anno = {}
    for v in range(n_videos):
        dur = float(rng.uniform(5, 30))
        acts = [[int(rng.randint(0, k)), float(rng.uniform(0, dur * 0.6)),
                 0.0] for _ in range(3)]
        for a in acts:
            a[2] = float(min(dur, a[1] + rng.uniform(1, dur * 0.5)))
        anno[f"V{v}"] = {"subset": "testing" if v % 3 else "training",
                         "duration": dur, "actions": acts}
    return anno


def test_localize_csv_bytes_and_evaluation_match_jax(tmp_path):
    k = 9
    anno = _annotations(k=k)
    rng = np.random.RandomState(3)
    probs = {vid: rng.rand(25, k).astype(np.float32) for vid in anno}
    paths = {}
    for name, mod in (("port", ploc), ("jax", jloc)):
        paths[name] = str(tmp_path / f"{name}.csv")
        with mod.LocalizeCSVWriter(paths[name]) as w:
            for vid, ann in anno.items():
                if vid == "V4":
                    continue  # missing from the submission
                w.add_video(vid, probs[vid], ann["duration"])
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        got, ref = f.read(), g.read()
    assert got == ref and got.count(b"\n") == 25 * 5
    with open(tmp_path / "anno.json", "w") as f:
        json.dump(anno, f)
    for subset in ("testing", None):
        for count_missing in (True, False):
            kw = dict(num_classes=k, subset=subset,
                      count_missing=count_missing)
            m, ap = pev.evaluate_localization(paths["port"], anno, **kw)
            jm, jap_ = jev.evaluate_localization(paths["jax"], anno, **kw)
            assert abs(m - jm) <= 1e-12 and 0 < m <= 1
            np.testing.assert_allclose(ap, jap_, rtol=0, atol=1e-12)
    sub = pev.load_submission(paths["port"])
    jsub = jev.load_submission(paths["jax"])
    assert sub.keys() == jsub.keys()
    for vid in sub:
        for (t, s), (jt, js) in zip(sub[vid], jsub[vid]):
            assert t == jt and np.array_equal(s, js)


def test_frame_labels_and_timestamps_match_jax():
    anno = _annotations(k=9, seed=5)
    for vid, ann in anno.items():
        ts = pev.canonical_timestamps(ann["duration"])
        assert ts == jev.canonical_timestamps(ann["duration"])
        for t in ts:
            assert np.array_equal(pev.frame_labels_at(ann, t, 9),
                                  jev.frame_labels_at(ann, t, 9))
