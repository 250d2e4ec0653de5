"""The port's examples (``coarse_fine_networks_torch/examples/``) end to end
on the CPU: ``demo_synthetic``'s three stages at a cut size, and
``demo_serving`` over HTTP, whose cold and cache-hit scores are equal and,
from the JAX pipeline's variables carried across by ``ckpt.from_jax``,
match the JAX demo's serving stack to 1e-4 in f32.  On the card
``chip_smoke.py``'s ``utils`` phase runs both with ``--device cuda``.
"""

import functools
import json
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from coarse_fine_networks_tpu.models import CoarseFinePipeline as JPipeline
from coarse_fine_networks_tpu.serve import CachingVideoServer as JServer
from coarse_fine_networks_tpu.serve import FeatureCache as JCache
from coarse_fine_networks_torch.ckpt import state_dict_from_jax
from coarse_fine_networks_torch.data.synthetic import generate_mini_charades
from coarse_fine_networks_torch.examples import demo_serving, demo_synthetic
from coarse_fine_networks_torch.train.config import DriverConfig

from _torch_port_util import jax_variables

torch.set_num_threads(2)


def test_demo_synthetic_end_to_end(tmp_path):
    """The demo's three stages with a cut configuration (4 videos of 40
    frames at 48², 7 classes, 2 steps): the fine checkpoint feeds the
    extraction, the banks the coarse stream, and the CSV is scored."""
    root = str(tmp_path)
    anno = generate_mini_charades(root, num_videos=4, num_frames=40, hw=48,
                                  num_classes=7)
    cfg = DriverConfig(
        anno=anno, root=os.path.join(root, "frames"),
        save_dir=os.path.join(root, "models"), num_classes=7,
        batch_size=2, val_batch_size=1, frames=8, min_frames=10,
        crop_size_override=32, max_epochs=2, train_phases_per_val=1,
        num_workers=1, ckpt_every=1, max_steps=2, pad_t_multiple=4,
        pad_label_multiple=8, resume=False, compute_dtype="float32",
        device="cpu")
    res = demo_synthetic.main(["--device", "cpu"], cfg=cfg)
    with open(anno) as f:
        videos = json.load(f)
    assert res["extracted"] == len(videos)
    for k in ("layer1", "conv5"):
        assert len(os.listdir(tmp_path / "fine_feats" / k)) == len(videos)
    assert os.path.getsize(tmp_path / "localize.csv") > 0
    assert 0.0 <= res["map"] <= 1.0
    assert all(np.isfinite(res["coarse"]["step_ms"]))


def _jax_scores(v):
    """The JAX demo's serving stack (its ``CachingVideoServer`` over the
    pipeline's ``extract`` and ``fuse``, no HTTP) on the demo's clips with
    the variables ``v``: the cold score."""
    m = JPipeline(n_classes=demo_serving.N_CLASSES)
    server = JServer(
        extract_fn=functools.partial(m.apply, v, method=JPipeline.extract),
        fuse_fn=functools.partial(m.apply, v, method=JPipeline.fuse),
        cache=JCache(capacity_bytes=1 << 28), max_batch=4, max_wait_ms=10)
    server.start()
    try:
        rng = np.random.RandomState(0)
        h = demo_serving.H
        clips = rng.rand(6, h, h, 3).astype(np.float32)
        fine = rng.rand(12, h, h, 3).astype(np.float32)
        return np.asarray(server.submit(clips, fine, video_id="demo-vid")
                          .result(timeout=600))
    finally:
        server.stop()


def test_demo_serving_matches_jax():
    """Cold and cache-hit scores over HTTP are equal; from the JAX
    pipeline's variables (its ``init`` tree, filled from a numpy seed: the
    demo's own jitted ``init`` takes a minute on the CPU) they match the
    JAX demo's serving stack to 1e-4."""
    h = demo_serving.H
    jm = JPipeline(n_classes=demo_serving.N_CLASSES)
    v = jax_variables(jm, jnp.zeros((1, 8, h, h, 3)),
                      jnp.zeros((1, 16, h, h, 3)),
                      jnp.asarray([[0, 8, 16, 1]], jnp.int32), seed=3)
    cold, hit = demo_serving.main(["--device", "cpu"],
                                  state_dict=state_dict_from_jax(v))
    np.testing.assert_array_equal(cold, hit)
    ref = _jax_scores(jax.tree.map(jnp.asarray, v))
    assert cold.shape == ref.shape
    np.testing.assert_allclose(cold, ref, rtol=1e-4, atol=1e-4)


def test_demo_serving_seeded_weights():
    """Without weights the demo draws them from seed 0: two runs score
    alike, and the cache hit equals the cold score."""
    a_cold, a_hit = demo_serving.main(["--device", "cpu"])
    b_cold, _ = demo_serving.main(["--device", "cpu"])
    np.testing.assert_array_equal(a_cold, a_hit)
    np.testing.assert_array_equal(a_cold, b_cold)
    assert np.all((a_cold > 0) & (a_cold < 1))
