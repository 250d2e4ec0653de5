"""The port's host data plane against the JAX package's on the same inputs:
the synthetic tree, the annotation table, every host transform (pixels and
random draws), ``CharadesDataset`` samples, the collates, the loader's
order and resume, and the pooled buffers' reuse.  Exact: the same numpy,
Pillow and ``random`` calls on both sides.  Both datasets decode with
Pillow (``decode_backend="pil"``); the native decoders are
held against each other in ``tests/test_torch_port_native.py``."""

import filecmp
import json
import os
import random
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from coarse_fine_networks_tpu.data import annotations as jann
from coarse_fine_networks_tpu.data import dataset as jds
from coarse_fine_networks_tpu.data import loader as jld
from coarse_fine_networks_tpu.data import synthetic as jsyn
from coarse_fine_networks_tpu.data import transforms as jtr
from coarse_fine_networks_torch.data import annotations as pann
from coarse_fine_networks_torch.data import bufpool
from coarse_fine_networks_torch.data import dataset as pds
from coarse_fine_networks_torch.data import loader as pld
from coarse_fine_networks_torch.data import synthetic as psyn
from coarse_fine_networks_torch.data import transforms as ptr
from coarse_fine_networks_torch.data.device_prefetch import DevicePrefetcher
from coarse_fine_networks_torch.train.common import model_batch

GEN = dict(num_videos=10, num_frames=36, hw=40, num_classes=11, seed=3)
# frames deleted from the end of some videos so that lengths differ
SHORTEN = {"SYN001": 24, "SYN004": 29, "SYN006": 22, "SYN008": 14}
KEYS = (("layer1", 6), ("conv5", 5))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The JAX and the port generator's trees from one seed, and a copy of
    the port's with shortened videos and a fine-feature cache (``.npy`` for
    layer1, the reference's torch layout for conv5, lengths 3-9)."""
    base = tmp_path_factory.mktemp("data")
    anno_j = jsyn.generate_mini_charades(str(base / "jax"), **GEN)
    anno_p = psyn.generate_mini_charades(str(base / "port"), **GEN)
    var = base / "varied"
    shutil.copytree(base / "port", var)
    for vid, keep in SHORTEN.items():
        for fr in range(keep + 1, GEN["num_frames"] + 1):
            os.remove(var / "frames" / vid / f"{vid}-{fr:06d}.jpg")
    rng = np.random.RandomState(0)
    feat_dir = var / "feats"
    for k, c in KEYS:
        os.makedirs(feat_dir / k)
    for v in range(GEN["num_videos"]):
        vid = f"SYN{v:03d}"
        t = rng.randint(3, 10)
        np.save(feat_dir / "layer1" / f"{vid}.npy",
                rng.rand(t, 7, 7, KEYS[0][1]).astype(np.float32))
        torch.save(torch.from_numpy(rng.rand(1, KEYS[1][1], t, 7, 7)
                                    .astype(np.float32)),
                   str(feat_dir / "conv5" / vid))
    return {"anno_j": anno_j, "anno_p": anno_p, "root_j": str(base / "jax"),
            "root_p": str(base / "port"), "anno": str(var / "annotations.json"),
            "frames": str(var / "frames"), "feats": str(feat_dir)}


def test_synthetic_tree_is_identical(trees):
    with open(trees["anno_j"]) as f, open(trees["anno_p"]) as g:
        assert json.load(f) == json.load(g)
    fj = os.path.join(trees["root_j"], "frames")
    fp = os.path.join(trees["root_p"], "frames")
    vids = sorted(os.listdir(fj))
    assert vids == sorted(os.listdir(fp)) and len(vids) == GEN["num_videos"]
    for vid in vids:
        names = sorted(os.listdir(os.path.join(fj, vid)))
        assert names == sorted(os.listdir(os.path.join(fp, vid)))
        _, mismatch, errors = filecmp.cmpfiles(
            os.path.join(fj, vid), os.path.join(fp, vid), names,
            shallow=False)
        assert not mismatch and not errors, (vid, mismatch, errors)
    name = sorted(os.listdir(os.path.join(fj, vids[0])))[5]
    a = np.asarray(Image.open(os.path.join(fj, vids[0], name)))
    b = np.asarray(Image.open(os.path.join(fp, vids[0], name)))
    assert a.shape == (GEN["hw"], GEN["hw"], 3) and np.array_equal(a, b)


def test_rasterize_annotations_matches_jax():
    rng = np.random.RandomState(1)
    for _ in range(20):
        dur = float(rng.uniform(1, 30))
        acts = [[int(rng.randint(0, 9)), float(rng.uniform(0, dur)),
                 float(rng.uniform(0, dur + 2))] for _ in range(4)]
        nf = int(rng.randint(0, 90))
        assert np.array_equal(pann.rasterize_annotations(acts, dur, nf, 9),
                              jann.rasterize_annotations(acts, dur, nf, 9))
    assert pann.rasterize_annotations([[0, 0, 1]], 0.0, 5).sum() == 0


@pytest.mark.parametrize("split", ["training", "testing"])
@pytest.mark.parametrize("use_cache", [False, True])
def test_make_dataset_matches_jax(trees, split, use_cache, tmp_path):
    kw = dict(num_classes=GEN["num_classes"], min_frames=25,
              use_cache=use_cache, cache_dir=str(tmp_path))
    for _ in range(2 if use_cache else 1):  # the second pass reads caches
        got = pann.make_dataset(trees["anno"], split, trees["frames"], **kw)
        ref = jann.make_dataset(trees["anno"], split, trees["frames"], **kw)
        assert [e[0] for e in got] == [e[0] for e in ref] and got
        for g, r in zip(got, ref):
            assert np.array_equal(g[1], r[1]) and g[2:] == r[2:]
    if use_cache:
        assert any(p.endswith("_labels_torch.npz")
                   for p in os.listdir(tmp_path))
    short = [e[0] for e in got if e[3] < 25]
    assert not short  # min_frames drops SYN001


def _img(w=52, h=40, seed=0):
    rng = np.random.RandomState(seed)
    return Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))


def _transforms(m):
    """The host transforms of module ``m``, by name, with (c_size, index)
    for ``randomize_parameters``."""
    s = [0.875, 0.7]
    return {
        "ToArray": (lambda: m.ToArray(), (0, 0)),
        "Normalize": (lambda: m.Compose([m.ToArray(), m.Normalize(
            (0.4, 0.3, 0.2), (0.2, 0.3, 0.1))]), (0, 0)),
        "Scale_int": (lambda: m.Scale(32), (0, 0)),
        "Scale_pair": (lambda: m.Scale((30, 20)), (0, 0)),
        "CenterCrop": (lambda: m.CenterCrop(24), (0, 0)),
        "CenterCropScaled": (lambda: m.CenterCropScaled(24), (0, 0)),
        **{f"CornerCrop_{i}": (lambda: m.CornerCrop(16), (0, i))
           for i in range(5)},
        "RandomHorizontalFlip": (lambda: m.RandomHorizontalFlip(), (0, 0)),
        "RandomHorizontalFlip_deferred": (
            lambda: m.RandomHorizontalFlip(deferred=True), (0, 0)),
        "RandomVerticalFlip": (lambda: m.RandomVerticalFlip(), (0, 0)),
        "MultiScaleCornerCrop": (
            lambda: m.MultiScaleCornerCrop([1.0, 0.84, 0.7], 24), (0, 0)),
        "MultiScaleRandomCrop": (lambda: m.MultiScaleRandomCrop(s, 24),
                                 (0, 0)),
        "MultiScaleRandomCropMultigrid": (
            lambda: m.MultiScaleRandomCropMultigrid(s, 24), (16, 0)),
        "MultiScaleRandomCropMultigrid_init": (
            lambda: m.MultiScaleRandomCropMultigrid(s, 24), (0, 0)),
        "train_pipeline": (lambda: m.Compose([
            m.MultiScaleRandomCropMultigrid(s, 32),
            m.RandomHorizontalFlip(deferred=True)]), (32, 0)),
        "flip_pipeline": (lambda: m.Compose([
            m.CenterCropScaled(24), m.RandomHorizontalFlip(),
            m.RandomVerticalFlip()]), (0, 0)),
    }


@pytest.mark.parametrize("name", sorted(_transforms(ptr)))
def test_host_transform_matches_jax(name):
    """Equal pixels and equal draws: after ``random.seed(s)`` and
    ``randomize_parameters``, the next ``random.random()`` agrees."""
    make_p, (c, idx) = _transforms(ptr)[name]
    make_j, _ = _transforms(jtr)[name]
    tp, tj = make_p(), make_j()
    for s in range(12):
        img = _img(seed=s)
        random.seed(s)
        tp.randomize_parameters(c, idx)
        got, after_p = tp(img), random.random()
        random.seed(s)
        tj.randomize_parameters(c, idx)
        ref, after_j = tj(img), random.random()
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), (name, s)
        assert after_p == after_j, (name, s)
        for attr in ("p", "flipped", "scale", "tl_x", "tl_y", "size",
                     "crop_position"):
            if hasattr(tj, attr):
                assert getattr(tp, attr) == getattr(tj, attr), (name, attr)


def _datasets(trees, split, crops, transforms, **kw):
    common = dict(task="loc", frames=8, gamma_tau=5, crops=crops,
                  min_frames=10, num_classes=GEN["num_classes"],
                  crop_size=32, fine_feat_dir=trees["feats"],
                  feature_keys=[k for k, _ in KEYS], seed=2, **kw)
    tp, tj = transforms(ptr), transforms(jtr)
    return (pds.CharadesDataset(trees["anno"], split, trees["frames"],
                                spatial_transform=tp, decode_backend="pil",
                                **common),
            jds.CharadesDataset(trees["anno"], split, trees["frames"],
                                spatial_transform=tj, decode_backend="pil",
                                **common))


def _train_t(m):
    return m.Compose([m.MultiScaleRandomCropMultigrid([0.875, 0.7], 32),
                      m.RandomHorizontalFlip(deferred=True)])


def _val_t(m):
    return m.Compose([m.CenterCropScaled(32)])


def _same_sample(got, ref):
    assert set(got) == set(ref)
    for k in ("clips", "label", "meta"):
        assert got[k].dtype == ref[k].dtype, k
        assert np.array_equal(got[k], ref[k]), k
    assert got["vid"] == ref["vid"] and got["dur"] == ref["dur"]
    assert got["flip"] == ref["flip"]
    for k in ref["feats"]:
        assert np.array_equal(got["feats"][k], ref["feats"][k]), k


@pytest.mark.parametrize("split,crops", [("training", 1), ("testing", 1),
                                         ("testing", 3)])
def test_dataset_samples_match_jax(trees, split, crops):
    tr = _train_t if split == "training" else _val_t
    dp, dj = _datasets(trees, split, crops, tr)
    assert len(dp) == len(dj) > 0
    random.seed(7)
    got = [dp[i] for i in range(len(dp))] * 1
    got += [dp[i] for i in range(len(dp))]  # a second pass, new draws
    random.seed(7)
    ref = [dj[i] for i in range(len(dj))]
    ref += [dj[i] for i in range(len(dj))]
    for g, r in zip(got, ref):
        _same_sample(g, r)
    assert got[0]["clips"].shape[0] == crops
    if split == "training":
        assert len({g["meta"][0] for g in got}) > 1  # the start is drawn
        assert any(g["flip"] for g in got) and not all(g["flip"] for g in got)


def _copy(out):
    return {k: ({kk: np.array(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else
                list(v) if isinstance(v, list) else np.array(v))
            for k, v in out.items()}


def _same_batch(got, ref):
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, dict):
            assert set(g) == set(r)
            for kk in r:
                assert np.array_equal(g[kk], r[kk]), (k, kk)
        elif isinstance(r, list):
            assert g == r, k
        else:
            assert g.dtype == r.dtype and np.array_equal(g, r), k


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("coarse", [False, True])
def test_collate_matches_jax(trees, bucket, coarse):
    dp, dj = _datasets(trees, "testing", 1, _val_t)
    for group in ([1, 4, 0], [3, 2]):
        samples = [dp[j] for j in group]
        assert len({s["clips"].shape[1] for s in samples}) > 1
        if coarse:
            kw = dict(feat_cap=6, pad_t_multiple=4, pad_label_multiple=8,
                      bucket=bucket)
            got = _copy(pds.collate_coarse(samples, **kw))
            ref = jds.collate_coarse(samples, **kw)
            assert got["feat_mask"].sum(axis=1).max() <= 6
        else:
            kw = dict(pad_t_multiple=4, pad_label_multiple=8, bucket=bucket)
            got = _copy(pds.collate_clips(samples, **kw))
            ref = jds.collate_clips(samples, **kw)
        _same_batch(got, ref)


@pytest.mark.parametrize("cfg", [
    dict(shuffle=True), dict(shuffle=True, drop_last=True),
    dict(shuffle=False, sort_key=True), dict(shuffle=True, shard=(1, 2))])
def test_loader_order_matches_jax(trees, cfg):
    dp, dj = _datasets(trees, "testing", 1, _val_t)
    cfg = dict(cfg)
    if cfg.pop("sort_key", False):
        cfg["sort_key"] = dp.num_frames

    def coll(b):
        return pds.collate_clips(b, 4, 8)

    lp = pld.PrefetchLoader(dp, 2, coll, num_workers=2, prefetch=2, seed=5,
                            **cfg)
    lj = jld.PrefetchLoader(dj, 2, coll, num_workers=2, prefetch=2, seed=5,
                            **cfg)
    assert len(lp) == len(lj)
    for _ in range(2):  # two epochs: the shuffle is keyed by the epoch
        got = [b["vids"] for b in lp]
        ref = [b["vids"] for b in lj]
        assert got == ref and got


def test_loader_resume_matches_uninterrupted(trees):
    """``state_dict`` inside an epoch → a new loader continues with the
    batches the JAX loader yields next; at an epoch's end it also carries
    the random state, so the next epoch's samples are the uninterrupted
    run's, pixel for pixel."""
    def coll(b):
        return pds.collate_clips(b, 4, 8)

    kw = dict(shuffle=True, num_workers=1, prefetch=1, seed=9)
    _, dj = _datasets(trees, "training", 1, _train_t)
    random.seed(4)
    lj = jld.PrefetchLoader(dj, 2, coll, **kw)
    ref = [_copy(b) for b in lj] + [_copy(b) for b in lj]
    assert len(ref) == 6  # five videos: batches of 2, 2 and 1

    dp, _ = _datasets(trees, "training", 1, _train_t)
    random.seed(4)
    lp = pld.PrefetchLoader(dp, 2, coll, **kw)
    it = iter(lp)
    head = [_copy(next(it)), _copy(next(it))]
    sd = lp.state_dict()
    assert (sd["epoch"], sd["pos"]) == (0, 2)
    it.close()
    lp2 = pld.PrefetchLoader(dp, 2, coll, **kw)
    lp2.load_state_dict(sd)
    assert (lp2.state_dict()["epoch"], lp2.state_dict()["pos"]) == (0, 2)
    tail = [_copy(b) for b in lp2]
    assert [b["vids"] for b in head + tail] == [b["vids"] for b in ref[:3]]

    dp, _ = _datasets(trees, "training", 1, _train_t)
    random.seed(4)
    lp = pld.PrefetchLoader(dp, 2, coll, **kw)
    first = [_copy(b) for b in lp]
    end = lp.state_dict()
    assert (end["epoch"], end["pos"]) == (0, 3)
    second = [_copy(b) for b in lp]
    for g, r in zip(first + second, ref):
        _same_batch(g, r)
    random.seed(123)  # clobbered: the state dict restores both states
    dp.rng.seed(99)
    lp3 = pld.PrefetchLoader(dp, 2, coll, **kw)
    lp3.load_state_dict(end)
    assert [b for b in lp3] == []  # epoch 0 is over
    again = [_copy(b) for b in lp3]
    assert len(again) == 3
    for g, r in zip(again, ref[3:]):
        _same_batch(g, r)


def test_loader_position_counts_the_batches_taken(trees):
    """Under a stage that runs ahead (the device prefetcher), the loader's
    state counts the batches the loop has taken (``consumed``), with the
    random state the next batch started from: with one worker a resume
    there gives the uninterrupted rest of the epoch and the next one, pixel
    for pixel, although the loader had collated every batch already."""
    def coll(b):
        return pds.collate_clips(b, 4, 8)

    kw = dict(shuffle=True, num_workers=1, prefetch=4, seed=9)
    dp, _ = _datasets(trees, "training", 1, _train_t)
    random.seed(4)
    lp = pld.PrefetchLoader(dp, 1, coll, **kw)
    ref = [_copy(b) for b in lp] + [_copy(b) for b in lp]
    assert len(ref) == 10

    dp, _ = _datasets(trees, "training", 1, _train_t)
    random.seed(4)
    lp = pld.PrefetchLoader(dp, 1, coll, **kw)
    it = iter(DevicePrefetcher(lp, _copy, depth=3, device="cpu"))
    head = [next(it) for _ in range(2)]
    lp.consumed(2)
    deadline = time.monotonic() + 60
    while lp._pos < 5 and time.monotonic() < deadline:
        time.sleep(0.05)  # the loader collates the epoch's other batches
    assert lp._pos == 5
    sd = lp.state_dict()
    assert (sd["epoch"], sd["pos"]) == (0, 2)
    it.close()
    random.seed(123)  # clobbered: the state dict restores both states
    dp.rng.seed(99)
    lp2 = pld.PrefetchLoader(dp, 1, coll, **kw)
    lp2.load_state_dict(sd)
    tail = [_copy(b) for b in lp2] + [_copy(b) for b in lp2]
    for g, r in zip(head + tail, ref):
        _same_batch(g, r)
    assert len(head + tail) == len(ref)


def test_loader_stops_its_threads_when_left_early(trees):
    dp, _ = _datasets(trees, "testing", 1, _val_t)
    before = set(threading.enumerate())
    lp = pld.PrefetchLoader(dp, 1, lambda b: pds.collate_clips(b, 4, 8),
                            num_workers=3, prefetch=1)
    it = iter(lp)
    next(it)
    started = [t for t in threading.enumerate() if t not in before]
    assert len(started) == 3
    it.close()  # joins them
    assert not [t for t in started if t.is_alive()]


class _FakeEvent:
    def __init__(self):
        self.waited = False

    def synchronize(self):
        self.waited = True


def test_bufpool_fence_holds_a_buffer_until_its_copy_ends(monkeypatch):
    monkeypatch.setenv("CFN_POOL_SLOTS", "3")
    monkeypatch.setattr(bufpool, "_MIN_SMALL", [0])
    monkeypatch.setattr(bufpool, "_MIN_LARGE", [0])
    monkeypatch.setattr(bufpool, "_EXTRA", [0])
    ring = bufpool.ArrayRing()
    bufs = [ring.borrow((4, 5), np.float32) for _ in range(3)]
    assert len({id(b) for b in bufs}) == 3
    ev = _FakeEvent()
    ring.fence([bufs[0], np.zeros(3)], ev)  # a foreign array is ignored
    again = ring.borrow((4, 5), np.float32)
    assert again is bufs[0] and ev.waited
    ev2 = _FakeEvent()
    ring.fence([bufs[2]], ev2)
    assert ring.borrow((4, 5), np.float32) is bufs[1] and not ev2.waited
    assert ring.borrow((4, 5), np.float32) is bufs[2] and ev2.waited
    monkeypatch.setenv("CFN_POOL_SLOTS", "0")
    assert ring.borrow((4, 5), np.float32) is not bufs[0]


def test_reused_buffers_do_not_corrupt_prefetched_batches(trees, monkeypatch):
    """The loader and the device prefetcher on the CPU, where the device
    batch's labels, masks and features share the pooled host buffers: with
    the smallest rings the loader and the prefetcher allow, a consumer that
    holds each batch for a while still reads the batch it was given.  The
    videos have one length and the features are capped at 3 frames, so
    every batch borrows from the same rings, and each video comes four
    times, so an epoch outruns the rings."""
    one = pds.CharadesDataset(
        trees["anno_p"], "testing", os.path.join(trees["root_p"], "frames"),
        spatial_transform=_val_t(ptr), frames=8, min_frames=10,
        num_classes=GEN["num_classes"], crop_size=32,
        fine_feat_dir=trees["feats"], feature_keys=[k for k, _ in KEYS],
        device="cpu")

    class Repeated:
        def __len__(self):
            return 4 * len(one)

        def __getitem__(self, i):
            return one[i % len(one)]

    dp = Repeated()

    def coll(b):
        return pds.collate_coarse(b, feat_cap=3, pad_t_multiple=4,
                                  pad_label_multiple=8)

    monkeypatch.setenv("CFN_POOL_SLOTS", "0")
    order = pld.PrefetchLoader(dp, 1, coll, shuffle=True, seed=3,
                               num_workers=1)
    ref = [model_batch(_copy(b), device="cpu") for b in order]
    ref = [{k: v for k, v in r.items() if k != "clips"} for r in ref]
    monkeypatch.setenv("CFN_POOL_SLOTS", "1")
    monkeypatch.setattr(bufpool, "_POOL", bufpool.ArrayRing())
    monkeypatch.setattr(bufpool, "_MIN_SMALL", [0])
    monkeypatch.setattr(bufpool, "_MIN_LARGE", [0])
    monkeypatch.setattr(bufpool, "_EXTRA", [0])
    loader = pld.PrefetchLoader(dp, 1, coll, shuffle=True, seed=3,
                                num_workers=2, prefetch=1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # threads switch often: races show
    try:
        for epoch in range(2):
            loader.epoch = 0
            got = 0
            for i, mb in enumerate(DevicePrefetcher(
                    loader, lambda b: model_batch(b, device="cpu"),
                    depth=2, device="cpu")):
                time.sleep(0.05)  # the loader runs ahead meanwhile
                for k, r in ref[i].items():
                    g = mb[k]
                    if isinstance(r, dict):
                        for kk in r:
                            assert torch.equal(g[kk], r[kk]), (epoch, i, kk)
                    else:
                        assert torch.equal(g, r), (epoch, i, k)
                got += 1
            assert got == len(ref)
    finally:
        sys.setswitchinterval(interval)
