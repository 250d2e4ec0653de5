"""The port's model router (``serve/router.py``): the JAX package's
``tests/test_router.py`` cases with torch stub models behind real port
schedulers on the CPU, and the canary split of 200 video ids equal to the
JAX router's ``resolve``.  Stub results are exact up to one f32 rounding
(rtol 1e-6)."""

import numpy as np
import pytest
import torch

from coarse_fine_networks_torch.serve import (ModelRouter, UnknownModelError,
                                              VideoServer)


def _stub_apply(scale):
    """Shape-faithful whole-video apply: (B,T,H,W,3) -> (B,label_len,3)."""
    def apply(clips, fine_clips, meta, label_len, fine_mask=None):
        per_clip = clips.mean(dim=(1, 2, 3)) * scale       # (B, 3)
        return per_clip[:, None, :].expand(clips.shape[0], label_len, 3)
    return apply


def _mk_server(scale, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_wait_ms", 5)
    kw.setdefault("bucket_multiple", 4)
    return VideoServer(_stub_apply(scale), devices="cpu", **kw)


@pytest.fixture
def router():
    r = ModelRouter()
    r.register("m-v1", _mk_server(1.0), default=True)
    r.register("m-v2", _mk_server(2.0))
    r.start()
    yield r
    r.stop()


def _video(seed=0, t=6, h=8):
    rng = np.random.RandomState(seed)
    return (rng.rand(t, h, h, 3).astype(np.float32),
            rng.rand(t * 2, h, h, 3).astype(np.float32))


def test_routing_and_default(router):
    clips, fine = _video()
    r_default = router.submit(clips, fine).result(timeout=60)
    r_v1 = router.submit(clips, fine, model="m-v1").result(timeout=60)
    r_v2 = router.submit(clips, fine, model="m-v2").result(timeout=60)
    np.testing.assert_allclose(r_default, r_v1)
    np.testing.assert_allclose(r_v2, 2.0 * r_v1, rtol=1e-6)
    assert r_v1.shape == (4 * clips.shape[0], 3)
    with pytest.raises(UnknownModelError):
        router.submit(clips, fine, model="nope")


def test_alias_is_atomic_rollout(router):
    clips, fine = _video(1)
    router.alias("prod", "m-v1")
    r1 = router.submit(clips, fine, model="prod").result(timeout=60)
    router.alias("prod", "m-v2")  # rollout: re-point, no server restart
    r2 = router.submit(clips, fine, model="prod").result(timeout=60)
    np.testing.assert_allclose(r2, 2.0 * r1, rtol=1e-6)
    with pytest.raises(UnknownModelError):
        router.alias("prod", "ghost")


def test_canary_split_deterministic(router):
    router.canary("m-v1", "m-v2", 0.5)
    # the same video id always resolves to the same variant
    picks = {router.resolve("m-v1", video_id="vidX") for _ in range(10)}
    assert len(picks) == 1
    # across many ids both variants get traffic at roughly the split
    names = [router.resolve("m-v1", video_id=f"v{i}") for i in range(200)]
    frac = names.count("m-v2") / len(names)
    assert 0.3 < frac < 0.7
    router.canary("m-v1", "m-v2", 0.0)  # clear
    assert all(router.resolve("m-v1", video_id=f"v{i}") == "m-v1"
               for i in range(20))
    with pytest.raises(UnknownModelError):
        router.canary("ghost", "m-v1", 0.5)


def test_stats_and_draining_stop(router):
    clips, fine = _video(2)
    router.submit(clips, fine, model="m-v2").result(timeout=60)
    stats = router.stats()
    assert set(stats) == {"m-v1", "m-v2"}
    assert stats["m-v2"]["batches_run"] >= 1
    router.stop()
    assert router.stopped
    with pytest.raises(RuntimeError):
        router.submit(clips, fine)


def test_register_after_start_and_duplicates(router):
    clips, fine = _video(3)
    router.register("m-v3", _mk_server(3.0))  # started by register
    r3 = router.submit(clips, fine, model="m-v3").result(timeout=60)
    r1 = router.submit(clips, fine, model="m-v1").result(timeout=60)
    np.testing.assert_allclose(r3, 3.0 * r1, rtol=1e-6)
    with pytest.raises(ValueError):
        router.register("m-v1", _mk_server(9.0))


@pytest.mark.parametrize("fraction", [0.1, 0.5, 0.9])
def test_canary_assignment_equals_jax(fraction):
    """Each of 200 video ids, and anonymous requests by the submission
    counter, lands on the variant the JAX router picks (sha1 of the id)."""
    from coarse_fine_networks_tpu.serve import ModelRouter as JRouter
    from coarse_fine_networks_tpu.serve import VideoServer as JServer
    from coarse_fine_networks_torch.serve.router import _split_key

    def jstub(*a, **k):
        raise AssertionError("never run")

    port, jax_ = ModelRouter(), JRouter()
    for r, mk in ((port, lambda: VideoServer(None, devices="cpu")),
                  (jax_, lambda: JServer(jstub))):
        r.register("cfn-m", mk(), default=True)
        r.register("cfn-xl", mk())
        r.canary("cfn-m", "cfn-xl", fraction)
    ids = [f"vid{i:03d}" for i in range(200)] + [None] * 20
    got = [port.resolve("cfn-m", video_id=v) for v in ids]
    ref = [jax_.resolve("cfn-m", video_id=v) for v in ids]
    assert got == ref
    assert got[:200] == ["cfn-xl" if _split_key(v, 0) < fraction else "cfn-m"
                         for v in ids[:200]]
    assert {"cfn-m", "cfn-xl"} <= set(got)


def test_results_are_float32_numpy_of_the_label_length(router):
    """The router's results are what the variant's scheduler returns: f32
    numpy of the request's label length (T = 8 fills its bucket, so the
    stub's mean sees no padded frame)."""
    clips, fine = _video(4, t=8)
    out = router.submit(clips, fine).result(timeout=60)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    np.testing.assert_allclose(
        out, np.broadcast_to(torch.from_numpy(clips).mean(dim=(0, 1, 2))
                             .numpy(), (32, 3)), rtol=1e-6)


def test_launch_counters_hold_under_concurrent_schedulers():
    """Two variants' schedulers launch kernels from their own threads: the
    wrappers' counter (a read-modify-write under a lock) loses no update
    under 16 threads switching every microsecond.  CPython 3.12 happens not
    to switch inside a bare ``+=`` on a dict item, so this holds the
    invariant; it does not reproduce a loss."""
    import sys
    import threading

    from coarse_fine_networks_torch.ops import dw_mm_act

    counts = {"k": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                dw_mm_act._count(counts, "k")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts["k"] == 16 * 2000
