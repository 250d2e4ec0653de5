"""Data-parallel serving of the port (``serve/scheduler.py``,
``serve/feature_cache.py``): a batch's rows split over per-device replicas
(padded to a device multiple with copies of row 0, sliced back), held
against the one-device server as ``tests/test_serve_mesh.py`` holds the
JAX package's mesh server: stub programs within 1e-6 relative, the real
X3D-M pipeline within 2e-4 (rows of another batch size sum in another
order), cold and cache hits; and the padding against the JAX package's
``_shard_rows``.  The devices are two (or three) CPU devices, each replica
its own copy of the pipeline."""

import copy

import numpy as np
import pytest
import torch


from coarse_fine_networks_tpu.parallel import make_mesh
from coarse_fine_networks_tpu.serve.scheduler import _shard_rows as jshard
from coarse_fine_networks_torch.models import CoarseFinePipeline
from coarse_fine_networks_torch.parallel.tensor import make_tp_tower
from coarse_fine_networks_torch.serve import (CachingVideoServer,
                                              FeatureCache, VideoServer)
from coarse_fine_networks_torch.serve.scheduler import _shard_rows

torch.set_num_threads(2)


def _stub_apply(clips, fine_clips, meta, label_len, fine_mask=None):
    per_clip = clips.mean(dim=(1, 2, 3)) + fine_clips.mean(dim=(1, 2, 3))
    return per_clip[:, None, :].expand(clips.shape[0], label_len, 3)


def _videos(n, seed=0, h=8):
    rng = np.random.RandomState(seed)
    return [(rng.rand(6, h, h, 3).astype(np.float32),
             rng.rand(12, h, h, 3).astype(np.float32)) for _ in range(n)]


def test_shard_rows_pads_as_jax():
    """Three rows over 2 devices: four rows (row 0 again), two a device,
    as the JAX package's ``_shard_rows`` pads and places them."""
    a = np.arange(3 * 2, dtype=np.float32).reshape(3, 2)
    parts, pb = _shard_rows([a], 2)
    (ja,), jpb = jshard([a], make_mesh(2), 3)
    assert pb == jpb == 4
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]),
                                  np.asarray(ja))
    np.testing.assert_array_equal(parts[1][0], [[4, 5], [0, 1]])


@pytest.mark.parametrize("n_dev", [2, 3])
def test_video_server_devices_match_single(n_dev):
    vids = _videos(3)
    results = {}
    for name, devs in (("dp", ["cpu"] * n_dev), ("single", "cpu")):
        s = VideoServer(_stub_apply, max_batch=4, max_wait_ms=50,
                        bucket_multiple=8, devices=devs).start()
        try:
            futs = [s.submit(c, f) for c, f in vids]
            results[name] = [fu.result(timeout=120) for fu in futs]
            assert s.batch_sizes == [3]
        finally:
            s.stop()
    for a, b in zip(results["dp"], results["single"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_replicas_must_match_the_devices():
    with pytest.raises(ValueError, match="replicas"):
        VideoServer([_stub_apply] * 3, devices=["cpu", "cpu"])


def test_caching_server_two_program_devices():
    """Both programs split their rows; hits and misses agree with the
    one-device server."""
    seen = []

    def extract(fine):
        seen.append(fine.shape[0])
        return {"tap": fine.mean(dim=(2, 3))[..., None, None, :]
                * torch.ones((1, 1, 7, 7, 1))}

    def fuse(clips, feats, feat_mask, meta, label_len):
        f = (feats["tap"].mean(dim=(2, 3))
             * feat_mask[..., None]).sum(dim=1)
        base = clips.mean(dim=(1, 2, 3)) + f
        return base[:, None, :].expand(clips.shape[0], label_len, 3)

    vids = _videos(3, seed=1)
    results = {}
    for name, devs in (("dp", ["cpu", "cpu"]), ("single", "cpu")):
        seen.clear()
        s = CachingVideoServer(extract_fn=extract, fuse_fn=fuse,
                               max_batch=4, max_wait_ms=50,
                               bucket_multiple=8, devices=devs).start()
        try:
            futs = [s.submit(c, f, video_id=f"v{i}")
                    for i, (c, f) in enumerate(vids)]
            out = [fu.result(timeout=120) for fu in futs]
            out.append(s.submit(vids[0][0], video_id="v0").result(
                timeout=120))
            assert s.cache.hits == 1
            results[name] = out
        finally:
            s.stop()
        assert seen == ([2, 2] if name == "dp" else [3])
    for a, b in zip(results["dp"], results["single"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def pipeline():
    return CoarseFinePipeline(7, "M", device="cpu",
                              generator=torch.Generator().manual_seed(0))


def test_caching_server_real_pipeline_devices(pipeline):
    """The X3D-M pipeline on two CPU replicas (cold, then a hit without
    fine pixels) against one replica: within 2e-4; a hit equals its cold
    request."""
    h, t, tf = 32, 8, 8
    rng = np.random.RandomState(5)
    vids = [(rng.rand(t - 2, h, h, 3).astype(np.float32),
             rng.rand(tf - 2, h, h, 3).astype(np.float32))
            for _ in range(3)]
    replicas = [pipeline, copy.deepcopy(pipeline)]
    results = {}
    for name, pipes in (("dp", replicas), ("single", [pipeline])):
        s = CachingVideoServer(
            extract_fn=[p.extract for p in pipes],
            fuse_fn=[p.fuse for p in pipes],
            cache=FeatureCache(capacity_bytes=1 << 28), max_batch=4,
            max_wait_ms=200, bucket_multiple=8,
            devices=[p.device for p in pipes]).start()
        try:
            futs = [s.submit(c, f, video_id=f"rp{i}")
                    for i, (c, f) in enumerate(vids)]
            out = [fu.result(timeout=600) for fu in futs]
            out.append(s.submit(vids[0][0], video_id="rp0").result(
                timeout=600))
            assert s.cache.hits == 1
            results[name] = out
        finally:
            s.stop()
    for a, b in zip(results["dp"], results["single"]):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    for name in results:
        np.testing.assert_allclose(results[name][3], results[name][0],
                                   rtol=1e-5, atol=1e-6)


def test_caching_server_tensor_parallel_extract(pipeline):
    """The miss path's extract on the tensor-parallel fine tower over two
    CPU shards (``make_tp_tower``), the fuse on the pipeline: the
    probabilities within 2e-4 of the one-device server's."""
    h = 32
    rng = np.random.RandomState(3)
    vids = [(rng.rand(6, h, h, 3).astype(np.float32),
             rng.rand(8, h, h, 3).astype(np.float32)) for _ in range(3)]
    tp = make_tp_tower(pipeline.fine, ["cpu", "cpu"])
    results = {}
    for name, extract in (("tp", tp), ("single", pipeline.extract)):
        s = CachingVideoServer(extract_fn=extract, fuse_fn=pipeline.fuse,
                               max_batch=4, max_wait_ms=200,
                               bucket_multiple=8, devices="cpu").start()
        try:
            futs = [s.submit(c, f, video_id=f"tp{i}")
                    for i, (c, f) in enumerate(vids)]
            results[name] = [fu.result(timeout=180) for fu in futs]
        finally:
            s.stop()
    for a, b in zip(results["tp"], results["single"]):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
