"""End-to-end serving demo on seeded weights, on the port: build the joint
pipeline, stand up the serving stack (scheduler → fine-feature cache →
router → HTTP on a free port), score a video over a real socket, then score
it again as a cache hit (no fine pixels sent).

    python -m coarse_fine_networks_torch.examples.demo_serving \
        [--device cuda|cpu]

The counterpart of ``examples/demo_serving.py`` at its shapes (32² frames,
a 6-frame coarse and a 12-frame fine clip, 17 classes, f32), on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import io
import json
import time
import urllib.request

import numpy as np
import torch

from ..models import CoarseFinePipeline
from ..serve import (CachingVideoServer, FeatureCache, InferenceHTTPServer,
                     ModelRouter)

H, N_CLASSES = 32, 17


def main(argv=None, state_dict=None):
    """Run the demo; ``state_dict``: the pipeline's weights (default: drawn
    from seed 0).  Returns the cold and the cache-hit probabilities."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    pipe = CoarseFinePipeline(n_classes=N_CLASSES, device=args.device,
                              generator=torch.Generator().manual_seed(0))
    if state_dict is not None:
        pipe.load_state_dict(state_dict, strict=True)
    server = CachingVideoServer(
        pipe.extract, pipe.fuse, cache=FeatureCache(capacity_bytes=1 << 28),
        max_batch=4, max_wait_ms=10, devices=pipe.device)
    router = ModelRouter().register("coarse_fine", server, default=True)
    srv = InferenceHTTPServer(router, port=0).start()
    try:
        print(f"serving on 127.0.0.1:{srv.port} ({pipe.device})", flush=True)
        rng = np.random.RandomState(0)
        clips = rng.rand(6, H, H, 3).astype(np.float32)
        fine = rng.rand(12, H, H, 3).astype(np.float32)

        def score(arrays, qs=""):
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/score{qs}",
                data=buf.getvalue())
            t0 = time.time()
            with urllib.request.urlopen(req, timeout=600) as r:
                probs = np.load(io.BytesIO(r.read()))["probs"]
            return probs, time.time() - t0

        p1, dt1 = score({"clips": clips, "fine_clips": fine},
                        "?video_id=demo-vid")
        print(f"cold score: probs {p1.shape} in {dt1:.2f}s "
              f"(extract + fuse)", flush=True)
        p2, dt2 = score({"clips": clips}, "?video_id=demo-vid")
        print(f"warm score: probs {p2.shape} in {dt2:.2f}s (cache hit, no "
              f"fine pixels sent)", flush=True)
        if not np.allclose(p1, p2, rtol=1e-5, atol=1e-6):
            raise RuntimeError(f"the cache hit differs from the cold score "
                               f"by {np.abs(p1 - p2).max()}")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/v1/stats", timeout=30) as r:
            print("stats:", json.dumps(json.loads(r.read())["coarse_fine"]))
    finally:
        srv.stop()
    print("done", flush=True)
    return p1, p2


if __name__ == "__main__":
    main()
