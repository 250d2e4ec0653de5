"""The port's serving layer on the CPU: the scheduler's contract (the
JAX package's ``tests/test_serve.py`` cases, with a torch stub model), the
feature cache, and the caching server against a direct
``CoarseFinePipeline`` call.  Probabilities agree to 1e-5: the same
pipeline runs in both, only the batch composition differs."""

import time

import numpy as np
import pytest
import torch

from coarse_fine_networks_torch.models import CoarseFinePipeline
from coarse_fine_networks_torch.serve import (CachingVideoServer,
                                              FeatureCache,
                                              ServerOverloadedError,
                                              VideoServer)

torch.set_num_threads(2)


def _stub_apply(c, f, m, label_len, fine_mask=None):
    """Echo what the server built: out[..., :4] = meta,
    out[..., 4] = sum(fine_mask) per sample."""
    out = torch.zeros((c.shape[0], label_len, 7))
    out[:, :, :4] = m[:, None, :].float()
    if fine_mask is not None:
        out[:, :, 4] = fine_mask.sum(dim=1)[:, None]
    return out


def _req(rng, t=5, tf=6, h=16, w=16):
    return (rng.rand(t, h, w, 3).astype(np.float32),
            rng.rand(tf, h, w, 3).astype(np.float32))


def _server(apply_fn=_stub_apply, **kw):
    return VideoServer(apply_fn, devices="cpu", **kw)


def test_backpressure_bounded_queue():
    rng = np.random.RandomState(0)
    server = _server(max_queue=2)  # not started: no drain
    server.submit(*_req(rng))
    server.submit(*_req(rng))
    with pytest.raises(ServerOverloadedError):
        server.submit(*_req(rng))


def test_priority_classes_and_aging():
    rng = np.random.RandomState(1)
    s = _server(max_batch=1, max_wait_ms=0, bucket_multiple=4,
                priority_aging_s=1000.0)
    s.submit(*_req(rng, t=3))
    s.submit(*_req(rng, t=20), priority=2)
    _, reqs = s._take_batch()
    assert reqs and reqs[0].priority == 2           # urgent first
    _, reqs = s._take_batch()
    assert reqs and reqs[0].priority == 0

    s2 = _server(max_batch=1, max_wait_ms=0, bucket_multiple=4,
                 priority_aging_s=1.0)
    lowf = s2.submit(*_req(rng, t=3))
    s2.submit(*_req(rng, t=20), priority=2)
    with s2._lock:
        for dq in s2._buckets.values():
            if dq and dq[0].priority == 0:
                dq[0].enqueued_at -= 10.0           # waited "10 s"
    _, reqs = s2._take_batch()
    assert reqs and reqs[0].priority == 0, "aged request must win"
    assert not lowf.done()


def test_submit_validates_shapes():
    server = _server()
    with pytest.raises(ValueError):
        server.submit(np.zeros((5, 16, 16)), np.zeros((5, 16, 16, 3)))
    with pytest.raises(ValueError):
        server.submit(np.zeros((5, 16, 16, 3)), np.zeros((5, 16, 16, 4)))


def test_request_timeout():
    """A lone request in a batch that never fills, behind a 60 s hold-open
    deadline, fails with TimeoutError within its 0.05 s timeout (plus the
    bounded idle wait), not after the hold-open deadline."""
    rng = np.random.RandomState(0)
    server = _server(max_batch=64, max_wait_ms=60_000,
                     request_timeout_s=0.05).start()
    try:
        t0 = time.monotonic()
        f = server.submit(*_req(rng))
        with pytest.raises(TimeoutError, match="waited"):
            f.result(timeout=30)
        assert time.monotonic() - t0 < 5.0
        assert server.timeouts == 1
    finally:
        server.stop()


def test_cancellation_before_launch():
    rng = np.random.RandomState(0)
    server = _server(max_batch=2, max_wait_ms=500).start()
    try:
        f1 = server.submit(*_req(rng))
        f2 = server.submit(*_req(rng, t=6))  # same bucket
        assert f2.cancel()
        assert f1.result(timeout=60).shape == (4 * 5, 7)
        deadline = time.monotonic() + 10
        while server.cancelled == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server.cancelled == 1
        assert server.batch_sizes == [1]
    finally:
        server.stop()


def test_error_isolation_keeps_serving():
    rng = np.random.RandomState(0)
    box = {"fail": True}

    def flaky(c, f, m, label_len, fine_mask=None):
        if box["fail"]:
            raise ValueError("injected")
        return _stub_apply(c, f, m, label_len, fine_mask)

    server = _server(flaky, max_batch=1, max_wait_ms=1).start()
    try:
        f1 = server.submit(*_req(rng))
        with pytest.raises(ValueError, match="injected"):
            f1.result(timeout=60)
        box["fail"] = False
        assert server.submit(*_req(rng)).result(timeout=60).shape == (20, 7)
    finally:
        server.stop()


def test_spatial_sizes_bucket_separately():
    rng = np.random.RandomState(0)
    server = _server(max_batch=8, max_wait_ms=30).start()
    try:
        f1 = server.submit(*_req(rng, h=16, w=16))
        f2 = server.submit(*_req(rng, h=32, w=16))
        f3 = server.submit(*_req(rng, h=16, w=16))
        for f in (f1, f2, f3):
            assert f.result(timeout=60).shape == (4 * 5, 7)
        assert server.batches_run == 2
        assert sorted(server.batch_sizes) == [1, 2]
    finally:
        server.stop()


def test_default_meta_and_fine_mask():
    rng = np.random.RandomState(0)
    server = _server(max_batch=1, max_wait_ms=1, bucket_multiple=16).start()
    try:
        t, tf = 5, 9  # tf pads to 16; the mask still sums to 9
        out = server.submit(*_req(rng, t=t, tf=tf)).result(timeout=60)
        np.testing.assert_array_equal(out[0, :4], [0, t, tf, 1])
        assert out[0, 4] == tf
    finally:
        server.stop()


def test_apply_runs_in_inference_mode_on_the_device():
    seen = {}

    def probe(c, f, m, label_len, fine_mask=None):
        seen["inference"] = torch.is_inference_mode_enabled()
        seen["device"] = c.device
        return _stub_apply(c, f, m, label_len, fine_mask)

    server = _server(probe, max_batch=1, max_wait_ms=1).start()
    try:
        server.submit(*_req(np.random.RandomState(0))).result(timeout=60)
    finally:
        server.stop()
    assert seen == {"inference": True, "device": torch.device("cpu")}


def test_feature_cache_lru_bytes():
    c = FeatureCache(capacity_bytes=3 * 400)  # 3 entries of 100 f32
    f = lambda: {"a": np.zeros(100, np.float32)}  # noqa: E731
    c.put("v1", f(), 5)
    c.put("v2", f(), 5)
    c.put("v3", f(), 5)
    assert len(c) == 3 and c.nbytes == 1200
    assert c.get("v1") is not None            # refresh v1
    c.put("v4", f(), 5)                       # evicts v2 (LRU)
    assert c.get("v2") is None
    assert c.get("v1") is not None and c.get("v4") is not None
    assert c.evictions == 1
    c.put("v1", f(), 5)                       # re-put: no double count
    assert c.nbytes == 1200
    c.put("huge", {"a": np.zeros(10_000, np.float32)}, 5)
    assert c.get("huge") is None


# ---- the caching server with the real (port) pipeline --------------------

H = 32


@pytest.fixture(scope="module")
def pipeline():
    return CoarseFinePipeline(n_classes=7, device="cpu",
                              generator=torch.Generator().manual_seed(0))


def _direct(m, clips, fine, t_pad, tf_pad):
    """One-program oracle at the padded bucket shapes, with the mask and
    meta the server derives."""
    t, tf = clips.shape[0], fine.shape[0]
    cp = np.zeros((1, t_pad, H, H, 3), np.float32)
    fp = np.zeros((1, tf_pad, H, H, 3), np.float32)
    fm = np.zeros((1, tf_pad), np.float32)
    cp[0, :t], fp[0, :tf], fm[0, :tf] = clips, fine, 1.0
    meta = torch.tensor([[0, t, tf, 1]], dtype=torch.int32)
    with torch.inference_mode():
        out = m(torch.from_numpy(cp), torch.from_numpy(fp), meta, 4 * t_pad,
                fine_mask=torch.from_numpy(fm))
    return out[0, : 4 * t].numpy()


def _caching(m, **kw):
    return CachingVideoServer(m.extract, m.fuse, devices="cpu", **kw).start()


def test_caching_server_miss_hit_match_direct(pipeline):
    rng = np.random.RandomState(0)
    server = _caching(pipeline, max_batch=4, max_wait_ms=50,
                      bucket_multiple=8)
    try:
        t, tf = 6, 7
        clips = rng.rand(t, H, H, 3).astype(np.float32)
        fine = rng.rand(tf, H, H, 3).astype(np.float32)
        ref = _direct(pipeline, clips, fine, 8, 8)
        assert np.ptp(ref) > 1e-3  # not a constant output

        r1 = server.submit(clips, fine, video_id="vidA").result(timeout=600)
        np.testing.assert_allclose(r1, ref, rtol=1e-5, atol=1e-5)
        assert server.cache.hits == 0 and len(server.cache) == 1

        r2 = server.submit(clips, video_id="vidA").result(timeout=600)
        np.testing.assert_allclose(r2, r1, rtol=1e-6, atol=1e-7)
        assert server.cache.hits == 1

        with pytest.raises(ValueError):
            server.submit(clips, video_id="nope")

        server.submit(clips, fine).result(timeout=600)  # anonymous
        assert len(server.cache) == 1
    finally:
        server.stop()


def test_caching_server_mixed_buckets_and_hit_in_larger_bucket(pipeline):
    """A miss batch spanning two requests, then a hit whose coarse clip
    lands in a larger bucket than the one its features were cached from."""
    rng = np.random.RandomState(1)
    server = _caching(pipeline, max_batch=2, max_wait_ms=200,
                      bucket_multiple=8)
    try:
        fine_a = rng.rand(7, H, H, 3).astype(np.float32)
        fine_b = rng.rand(5, H, H, 3).astype(np.float32)
        clips_a = rng.rand(6, H, H, 3).astype(np.float32)
        clips_b = rng.rand(8, H, H, 3).astype(np.float32)
        fa = server.submit(clips_a, fine_a, video_id="a")
        fb = server.submit(clips_b, fine_b, video_id="b")
        np.testing.assert_allclose(fa.result(timeout=600),
                                   _direct(pipeline, clips_a, fine_a, 8, 8),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(fb.result(timeout=600),
                                   _direct(pipeline, clips_b, fine_b, 8, 8),
                                   rtol=1e-5, atol=1e-5)
        assert server.batch_sizes == [2]

        clips_long = rng.rand(12, H, H, 3).astype(np.float32)  # bucket 16
        got = server.submit(clips_long, video_id="a").result(timeout=600)
        np.testing.assert_allclose(got, _direct(pipeline, clips_long, fine_a,
                                                16, 8),
                                   rtol=1e-5, atol=1e-5)
        assert server.cache.hits == 1
    finally:
        server.stop()


def test_caching_server_timeout():
    server = CachingVideoServer(None, None, devices="cpu", max_batch=64,
                                max_wait_ms=60_000,
                                request_timeout_s=0.05).start()
    try:
        f = server.submit(*_req(np.random.RandomState(2)))
        with pytest.raises(TimeoutError):
            f.result(timeout=30)
    finally:
        server.stop()
