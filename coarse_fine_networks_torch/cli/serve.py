"""``python -m coarse_fine_networks_torch.cli.serve --fine-ckpt <fine.ckpt>
--coarse-ckpt <coarse.ckpt> [--port 8000]`` (or ``--ckpt <joint.ckpt>``)

The inference service (counterpart of
``coarse_fine_networks_tpu/cli/serve.py``): the joint Coarse-Fine pipeline
from the port's checkpoints, behind the continuous-batching scheduler, the
fine-feature cache and the model router, served over HTTP
(:mod:`..serve.http`):

    POST /v1/score?video_id=<id>   raw .npz {clips[, fine_clips]} -> probs
    GET  /v1/models  /v1/stats  /healthz

The JAX flags, plus ``--device`` (``cuda`` unless given): on the card the
pipeline runs in bf16, on the CPU in f32.  ``--mesh-devices N`` serves
data-parallel on N replicas of the pipeline, replica ``i`` on
``cuda:(i % device_count)`` (on the CPU, N replicas on the CPU), each
batch's rows split over them (:mod:`..serve.scheduler`); the placement is
printed.  ``--port 0`` picks a free port, which the ``serving on :<port>``
line names; SIGTERM or SIGINT drains and exits with 0.
"""

from __future__ import annotations

import argparse
import signal
import threading

import torch

# the fine stream's logits head: a fine-stream training checkpoint has it,
# the pipeline's global tower does not (the JAX apply ignores it)
FINE_HEAD = ("fine.fc1.", "fine.fc2.")


def serving_devices(device: str, mesh_devices: int | None
                    ) -> list[torch.device]:
    """The replicas' devices: ``device`` alone, or with ``mesh_devices = N
    > 1`` replica ``i`` on ``cuda:(i % device_count)`` (on the CPU, N
    times the CPU)."""
    from ..parallel.mesh import rank_device

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device")
    n = mesh_devices or 1
    if n <= 1:
        return [dev]
    return [rank_device(i, dev.type) for i in range(n)]


def assemble_pipeline_variables(ckpt: str | None, fine_ckpt: str | None,
                                coarse_ckpt: str | None, version: str = "M",
                                num_classes: int = 157
                                ) -> dict[str, torch.Tensor]:
    """The :class:`..models.CoarseFinePipeline` ``state_dict`` (``fine.*``,
    ``coarse.*``) from one joint checkpoint, or from the two per-stream
    checkpoints the drivers write (``train_fine`` and
    ``train_coarse_fineFEAT``: their ``variables``; reference ``.pt``/
    ``.pth`` files load too).

    Loaded strictly (:func:`..ckpt.load_strict`) into the pipeline of
    ``version`` and ``num_classes``: a missing tensor, an unknown key or a
    shape that differs raises, where :func:`..train.load_pretrained` would
    keep the fresh init and the server would answer with random weights.
    Only the fine stream's logits head (``fine.fc1.*``, ``fine.fc2.*``) and
    the reference's ``num_batches_tracked`` counters are dropped.  A fine
    checkpoint saved in long-cycle phase A, B or C carries 8, 4 or 2
    batch-norm splits: the pipeline takes them, then its eval statistics
    are set from them (:func:`..models.aggregate_sub_bn_stats`), as the
    JAX package does before serving, since training keeps only the split
    statistics."""
    from ..ckpt import checkpoint_tensors, load_strict
    from ..models import CoarseFinePipeline, aggregate_sub_bn_stats

    if ckpt:
        sd = checkpoint_tensors(ckpt)
        towers = {k.split(".", 1)[0] for k in sd}
        if not {"fine", "coarse"} <= towers:
            raise ValueError(
                f"{ckpt} is not a joint pipeline checkpoint; pass "
                "--fine-ckpt/--coarse-ckpt for per-stream artifacts")
    elif fine_ckpt and coarse_ckpt:
        sd = {f"fine.{k}": v for k, v in checkpoint_tensors(fine_ckpt).items()}
        sd.update({f"coarse.{k}": v
                   for k, v in checkpoint_tensors(coarse_ckpt).items()})
    else:
        raise ValueError("need --ckpt or both --fine-ckpt/--coarse-ckpt")
    pipe = CoarseFinePipeline(num_classes, version, device="cpu")
    load_strict(pipe, sd, drop=FINE_HEAD)
    return aggregate_sub_bn_stats(pipe).state_dict()


def caching_server(pipe, cache_bytes: int, max_batch: int,
                   max_wait_ms: float, max_queue: int,
                   request_timeout_s: float | None,
                   prewarm_dir: str | None = None):
    """A :class:`..serve.CachingVideoServer` over ``pipe``'s ``extract`` and
    ``fuse`` on its device (or, given a list of pipelines on their
    devices, data-parallel over their replicas), with a cache of
    ``cache_bytes`` warmed from the extraction bank ``prewarm_dir``."""
    from ..serve import CachingVideoServer, FeatureCache

    cache = FeatureCache(capacity_bytes=cache_bytes)
    if prewarm_dir:
        n = cache.preload_dir(prewarm_dir)
        print(f"prewarmed {n} videos ({cache.nbytes / 1e9:.2f} GB) from "
              f"{prewarm_dir}", flush=True)
    pipes = pipe if isinstance(pipe, (list, tuple)) else [pipe]
    return CachingVideoServer(
        [p.extract for p in pipes], [p.fuse for p in pipes], cache=cache,
        max_batch=max_batch, max_wait_ms=max_wait_ms, max_queue=max_queue,
        request_timeout_s=request_timeout_s,
        devices=[p.device for p in pipes])


def build_server(variables, version: str, num_classes: int, port: int,
                 cache_bytes: int, max_batch: int, max_wait_ms: float,
                 max_queue: int, request_timeout_s: float | None,
                 prewarm_dir: str | None = None,
                 mesh_devices: int | None = None,
                 device: str = "cuda", compute_dtype=None):
    """The HTTP server of one ``coarse_fine`` model: a
    :class:`..models.CoarseFinePipeline` of ``version`` on ``device``
    (in ``compute_dtype``: by default bf16 on the card, f32 on the CPU)
    loaded strictly with ``variables``, behind :func:`caching_server` and a
    :class:`..serve.ModelRouter`; with ``mesh_devices = N > 1`` one
    replica on each of :func:`serving_devices`."""
    from ..ckpt import load_strict
    from ..models import CoarseFinePipeline
    from ..serve import InferenceHTTPServer, ModelRouter

    devices = serving_devices(device, mesh_devices)
    if compute_dtype is None:
        compute_dtype = (torch.bfloat16 if devices[0].type == "cuda"
                         else torch.float32)
    pipes = []
    for i, dev in enumerate(devices):
        pipe = CoarseFinePipeline(num_classes, version,
                                  compute_dtype=compute_dtype, device="cpu")
        load_strict(pipe, variables)
        pipes.append(pipe.to(dev))
        if len(devices) > 1:
            print(f"replica {i} on {dev}", flush=True)
    server = caching_server(pipes, cache_bytes, max_batch, max_wait_ms,
                            max_queue, request_timeout_s, prewarm_dir)
    router = ModelRouter().register("coarse_fine", server, default=True)
    return InferenceHTTPServer(router, port=port)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Serve Coarse-Fine joint inference over HTTP")
    p.add_argument("--ckpt", default=None,
                   help="joint pipeline checkpoint (.ckpt)")
    p.add_argument("--fine-ckpt", default=None,
                   help="fine-stream driver checkpoint (with --coarse-ckpt)")
    p.add_argument("--coarse-ckpt", default=None,
                   help="coarse-stream driver checkpoint (with --fine-ckpt)")
    p.add_argument("--version", default="M", choices=("S", "M", "XL"))
    p.add_argument("--num-classes", type=int, default=157)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--cache-gb", type=float, default=1.0,
                   help="fine-feature cache capacity")
    p.add_argument("--prewarm-dir", default=None,
                   help="extract_fineFEAT bank dir to preload the cache")
    p.add_argument("--mesh-devices", type=int, default=None,
                   help="data-parallel serving over N replicas, replica i "
                        "on cuda:(i %% device_count); each batch's rows "
                        "split over them")
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--request-timeout-s", type=float, default=120.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda: bf16; cpu: f32)")
    args = p.parse_args(argv)

    serving_devices(args.device, args.mesh_devices)
    variables = assemble_pipeline_variables(
        args.ckpt, args.fine_ckpt, args.coarse_ckpt, args.version,
        args.num_classes)
    srv = build_server(variables, args.version, args.num_classes, args.port,
                       int(args.cache_gb * (1 << 30)), args.max_batch,
                       args.max_wait_ms, args.max_queue,
                       args.request_timeout_s, prewarm_dir=args.prewarm_dir,
                       mesh_devices=args.mesh_devices,
                       device=args.device).start()
    print(f"serving on :{srv.port} (POST /v1/score)", flush=True)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: done.set())
    signal.signal(signal.SIGINT, lambda *a: done.set())
    while not done.wait(1.0):
        pass
    srv.stop()
    return 0


if __name__ == "__main__":
    main()
