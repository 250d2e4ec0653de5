"""The port's HTTP front end (``serve/http.py``) through a real socket on
the CPU, with torch stub models behind real port schedulers: the JAX
package's ``tests/test_http_serve.py`` round trip, routing and error codes
(404, 400), plus overload (429), timeout (504) and draining (503); and
``FeatureCache.preload_dir`` against the JAX one on the same bank
directories (the port's ``.npy`` banks and the reference's ``torch.save``
files): the same admitted ids, equal arrays, the same survivors at a
capacity that evicts.  Stub results are exact up to one f32 rounding
(rtol 1e-6); preloaded banks are equal exactly."""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from coarse_fine_networks_torch.serve import (FeatureCache,
                                              InferenceHTTPServer,
                                              ModelRouter, VideoServer)


def _stub_apply(scale):
    def apply(clips, fine_clips, meta, label_len, fine_mask=None):
        per_clip = clips.mean(dim=(1, 2, 3)) * scale
        return per_clip[:, None, :].expand(clips.shape[0], label_len, 3)
    return apply


def _server(scale, **kw):
    kw = {"max_batch": 2, "max_wait_ms": 5, "bucket_multiple": 4, **kw}
    return VideoServer(_stub_apply(scale), devices="cpu", **kw)


@pytest.fixture
def http_server():
    r = ModelRouter()
    r.register("m-v1", _server(1.0), default=True)
    r.register("m-v2", _server(2.0))
    s = InferenceHTTPServer(r, port=0).start()
    yield s
    s.stop()


def _post(port, path, arrays, timeout=60):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _code(fn, *a, **k):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*a, **k)
    return e.value.code


def test_score_roundtrip_and_routing(http_server):
    port = http_server.port
    rng = np.random.RandomState(0)
    clips = rng.rand(6, 8, 8, 3).astype(np.float32)
    fine = rng.rand(12, 8, 8, 3).astype(np.float32)

    st, body = _post(port, "/v1/score", {"clips": clips, "fine_clips": fine})
    assert st == 200
    with np.load(io.BytesIO(body)) as z:
        p1 = z["probs"]
    assert p1.shape == (24, 3) and p1.dtype == np.float32
    # the stub's mean over the padded bucket (T=6 pads to 8)
    np.testing.assert_allclose(p1[0], clips.sum(axis=(0, 1, 2)) / (8 * 64),
                               rtol=1e-6)

    st, body = _post(port, "/v1/score?model=m-v2&priority=3",
                     {"clips": clips, "fine_clips": fine})
    assert st == 200
    with np.load(io.BytesIO(body)) as z:
        p2 = z["probs"]
    np.testing.assert_allclose(p2, 2.0 * p1, rtol=1e-6)


def test_endpoints_and_errors(http_server):
    port = http_server.port
    st, models = _get_json(port, "/v1/models")
    assert st == 200 and models["models"] == ["m-v1", "m-v2"]
    st, health = _get_json(port, "/healthz")
    assert st == 200 and health["status"] == "ok"

    clips = np.zeros((4, 8, 8, 3), np.float32)
    fine = np.zeros((8, 8, 8, 3), np.float32)
    # unknown model -> 404
    assert _code(_post, port, "/v1/score?model=ghost",
                 {"clips": clips, "fine_clips": fine}) == 404
    # malformed payload -> 400
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/score",
                                 data=b"not-an-npz")
    assert _code(urllib.request.urlopen, req, timeout=30) == 400
    # bad shape -> 400
    assert _code(_post, port, "/v1/score",
                 {"clips": np.zeros((3, 3), np.float32),
                  "fine_clips": fine}) == 400
    # a plain server needs fine pixels -> 400
    assert _code(_post, port, "/v1/score", {"clips": clips}) == 400
    # unknown routes -> 404
    assert _code(_get_json, port, "/v1/nope") == 404
    assert _code(_post, port, "/v1/nope", {"clips": clips}) == 404

    _post(port, "/v1/score", {"clips": clips, "fine_clips": fine})
    st, stats = _get_json(port, "/v1/stats")
    assert st == 200 and stats["m-v1"]["batches_run"] >= 1
    assert set(stats["m-v1"]) == {"pending", "batches_run", "mean_batch",
                                  "timeouts", "cancelled"}


def test_overload_timeout_and_draining():
    """A variant that holds its batch open (max_wait 60 s) never runs: the
    first request times out at the front end (504) while a concurrent one
    finds the queue of one full (429); once the router drains, /healthz
    answers 503."""
    r = ModelRouter()
    r.register("held", _server(1.0, max_batch=4, max_wait_ms=60_000,
                                max_queue=1))
    s = InferenceHTTPServer(r, port=0, result_timeout_s=1.0).start()
    clips = np.zeros((4, 8, 8, 3), np.float32)
    body = {"clips": clips, "fine_clips": clips}
    codes = {}

    def first():
        codes["first"] = _code(_post, s.port, "/v1/score", body)

    try:
        t = threading.Thread(target=first)
        t.start()
        deadline = time.monotonic() + 30
        while (r.stats()["held"]["pending"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        codes["second"] = _code(_post, s.port, "/v1/score", body)
        t.join(timeout=30)
        assert codes == {"first": 504, "second": 429}
        r.stop()
        assert _code(_get_json, s.port, "/healthz") == 503
    finally:
        s.stop()


# ---- FeatureCache.preload_dir against the JAX package's ------------------

CHANS = {"layer1": 24, "layer2": 48, "layer3": 96, "layer4": 192,
         "conv5": 432}
LENGTHS = {"VC": 4, "VA": 5, "VB": 9}


def _bank(root, reference: bool):
    """A bank of three videos: the port's ``<key>/<vid>.npy`` (T, 7, 7, C)
    or the reference's ``torch.save`` of (1, C, T, 7, 7) named ``<vid>``;
    returns each video's (T, 7, 7, C) arrays."""
    rng = np.random.RandomState(7)
    want = {}
    for k in FeatureCache.FEATURE_KEYS:
        os.makedirs(root / k)
    for vid, t in LENGTHS.items():
        want[vid] = {}
        for k in FeatureCache.FEATURE_KEYS:
            a = rng.rand(t, 7, 7, CHANS[k]).astype(np.float32)
            want[vid][k] = a
            if reference:
                torch.save(torch.from_numpy(a).permute(3, 0, 1, 2)[None]
                           .contiguous(), str(root / k / vid))
            else:
                np.save(str(root / k / f"{vid}.npy"), a)
    return want


@pytest.mark.parametrize("reference", [False, True], ids=["npy", "torch"])
def test_preload_dir_matches_jax(tmp_path, reference):
    from coarse_fine_networks_tpu.serve.feature_cache import \
        FeatureCache as JCache

    want = _bank(tmp_path, reference)
    frame = sum(a.nbytes for a in want["VA"].values()) // LENGTHS["VA"]
    for cap, max_videos in ((1 << 30, None), (1 << 30, 2),
                            (27 * frame // 2, None)):
        port, jax_ = FeatureCache(cap), JCache(cap)
        n = port.preload_dir(str(tmp_path), max_videos=max_videos)
        assert n == jax_.preload_dir(str(tmp_path), max_videos=max_videos)
        assert list(port._data) == list(jax_._data)
        assert port.evictions == jax_.evictions
        assert port.nbytes == jax_.nbytes
        for vid, (feats, t) in port._data.items():
            jfeats, jt = jax_._data[vid]
            assert t == jt == LENGTHS[vid]
            for k in FeatureCache.FEATURE_KEYS:
                assert feats[k].dtype == np.float32
                assert feats[k].flags["C_CONTIGUOUS"]
                np.testing.assert_array_equal(feats[k], jfeats[k])
                np.testing.assert_array_equal(feats[k], want[vid][k])
    # sorted admission: at a capacity of 13.5 frames VA (5) goes when VB
    # (9) comes, and VB and VC (4) survive
    assert list(port._data) == ["VB", "VC"] and port.evictions == 1
