#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``coarse_fine_networks_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build of the hand-written kernels from ``csrc/``;
2. kernels: each fused bottleneck-entry kernel against its plain PyTorch
   version on the card, at the 16 entry shapes the serve phase gives it
   (batch 3 at 224²; the fine tower at T_f=128, the coarse tower at T=64
   in layer1 and T=17 after Grid Pool, which leaves a short last frame
   segment), in f32 (TF32 off) and bf16, with timings of the kernel, the
   plain version and the unfused PyTorch sequence (no single PyTorch call
   computes this function);
3. serve: the joint pipeline (X3D-M, 157 classes, bf16, seeded random
   weights) behind ``CachingVideoServer`` on the card, at full width:
   three cold requests (two at T=64/T_f=128, one at T=50/T_f=100 that pads
   into the same bucket) and their cache-hit repeats without fine pixels;
   the kernels' launch counters are read for this run;
4. profile: the device-time breakdown of one cold batch under
   ``torch.profiler`` (kernel time by name, the card's busy share);
5. card_vs_cpu: one small f32 request through the port on the card and on
   the CPU (probabilities, feature banks and the coarse logits);
6. a ``{"kernels": [...]}`` line, then the card's ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` last.

Any failed check raises and the script exits non-zero before the last line.
It needs no network and writes nothing outside the checkout (the kernel
build goes to ``coarse_fine_networks_torch/_build/``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; bf16 tensor-core
# and f32 (non-tensor) operations/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain, as a fraction of max|plain|: f32 sums in another order;
# bf16 output rounding (and the odd flip of a bf16-rounded activation)
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# bottleneck entries per stage at 224²: (stage, H_in and C_in of block 0
# (stride 2), H_in and C_in after it, C_mid, bottlenecks in the stage)
ENTRY_SHAPES = [
    ("layer1", 112, 24, 56, 24, 54, 3),
    ("layer2", 56, 24, 28, 48, 108, 5),
    ("layer3", 28, 48, 14, 96, 216, 11),
    ("layer4", 14, 96, 7, 192, 432, 7),
]
# the serve phase's batches: B videos, each tower's frames per stage (the
# coarse tower runs layers 2-4 on the T/4+1 frames Grid Pool keeps), and the
# tower's calls in that phase's counted run (fine: one cold extract; coarse:
# the cold fuse and the hit fuse)
SERVE_B = 3
TOWERS = {
    "fine": ({"layer1": 128, "layer2": 128, "layer3": 128, "layer4": 128}, 1),
    "coarse": ({"layer1": 64, "layer2": 17, "layer3": 17, "layer4": 17}, 2),
}
REPLACES = {
    "dw_mm_act_s1": "coarse_fine_networks_tpu/ops/pallas/dw_fold.py:532",
    "dw_mm_act_s2": "coarse_fine_networks_tpu/ops/pallas/dw_fold.py:1078",
}
SOURCE = "coarse_fine_networks_torch/csrc/dw_mm_act.cu"


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def entry_cases():
    """(kernel, label, B, T, H, W, C_in, C_mid, stride, launches) of the 16
    entry shapes the serve phase gives the kernels (8 per tower, at its
    batch); ``launches`` is how often the counted serve run launches each."""
    for tower, (frames, calls) in TOWERS.items():
        for layer, h_s2, cin_s2, h_s1, cin_s1, c_mid, n in ENTRY_SHAPES:
            t = frames[layer]
            yield ("dw_mm_act_s2", f"{tower}.{layer}.0", SERVE_B, t, h_s2,
                   h_s2, cin_s2, c_mid, 2, calls)
            yield ("dw_mm_act_s1", f"{tower}.{layer}.1-{n - 1}", SERVE_B, t,
                   h_s1, h_s1, cin_s1, c_mid, 1, (n - 1) * calls)


def phase_device(dw_mm_act) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    dw_mm_act.build()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "build_s": round(time.perf_counter() - t0, 3)})
    return smi


def phase_kernels(dw_mm_act) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {k: {"ms": 0.0, "plain_ms": 0.0, "unfused_ms": 0.0,
                      "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                      "max_abs_err": 0.0, "max_abs_err_f32": 0.0,
                      "launches": 0} for k in REPLACES}
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, b, t, h, w, c_in, c_mid, s, n in entry_cases():
            def rnd(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda") * scale
            x = rnd(b, t, h, w, c_in).to(dtype)
            w1 = rnd(c_in, c_mid, scale=c_in ** -0.5).to(dtype)
            w_dw = rnd(3, 3, 3, c_mid, scale=27 ** -0.5).to(dtype)
            sc = torch.rand(c_mid, generator=gen, device="cuda") + 0.5
            bi = rnd(c_mid)  # about half negative: the zero frame matters
            args = (x, w1, w_dw, sc, bi, s)

            got = dw_mm_act.dw_mm_bnrelu_conv3d(*args)
            ref = dw_mm_act.dw_mm_bnrelu_conv3d_plain(*args)
            torch.cuda.synchronize()
            check(got.shape == ref.shape and got.dtype == dtype,
                  f"{name} {label} {dtype}: shape/dtype {got.shape}")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = TOL[dtype] * max(scale, 1.0)

            w_conv = w_dw.permute(3, 0, 1, 2).unsqueeze(1).contiguous()

            def unfused():
                z = torch.matmul(x, w1)
                a = torch.relu(z.float() * sc + bi).to(dtype)
                return F.conv3d(a.permute(0, 4, 1, 2, 3), w_conv,
                                stride=(1, s, s), padding=1,
                                groups=c_mid).permute(0, 2, 3, 4, 1)

            ms = cuda_ms(lambda: dw_mm_act.dw_mm_bnrelu_conv3d(*args), 20)
            plain_ms = cuda_ms(
                lambda: dw_mm_act.dw_mm_bnrelu_conv3d_plain(*args), 3, 1)
            unfused_ms = cuda_ms(unfused, 10)
            ho, wo = got.shape[2], got.shape[3]
            esz = x.element_size()
            nbytes = (x.numel() + got.numel() + w1.numel()
                      + w_dw.numel()) * esz + 2 * c_mid * 4
            ops = 2 * b * t * (h * w * c_in * c_mid + 27 * ho * wo * c_mid)
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            ops_ms = ops / PEAK_OPS[dtype] * 1e3
            row = {"phase": "kernels", "kernel": name, "entry": label,
                   "dtype": str(dtype).replace("torch.", ""),
                   "x": [b, t, h, w, c_in], "c_mid": c_mid, "stride": s,
                   "serve_launches": n, "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
                   "tol_abs": tol, "ms": ms, "plain_ms": plain_ms,
                   "unfused_ms": unfused_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else
                   "operations", "bytes": nbytes, "ops": ops,
                   "library_ms": None,
                   "library_note": "no single PyTorch call computes "
                                   "dwconv(relu(x@W1*sc+bi))"}
            emit(row)
            check(err <= tol, f"{name} {label} {dtype}: max abs err {err} "
                              f"> {tol}")
            agg = per_kernel[name]
            if dtype == torch.bfloat16:
                # the served dtype: each shape weighted by its launches in
                # the counted serve run, so the sums are that run's work
                for key, v in (("ms", ms), ("plain_ms", plain_ms),
                               ("unfused_ms", unfused_ms),
                               ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                               ("bound_ms", row["bound_ms"])):
                    agg[key] += n * v
                agg["launches"] += n
                agg["max_abs_err"] = max(agg["max_abs_err"], err)
            else:
                agg["max_abs_err_f32"] = max(agg["max_abs_err_f32"], err)
            del x, got, ref
        torch.cuda.empty_cache()
    return per_kernel


def _clip(rng: torch.Generator, t: int, hw: int):
    return torch.rand((t, hw, hw, 3), generator=rng).numpy()


def phase_serve(dw_mm_act, want: dict) -> dict:
    """``want``: the launches of each kernel the counted run must make."""
    from coarse_fine_networks_torch.models import CoarseFinePipeline
    from coarse_fine_networks_torch.serve import (CachingVideoServer,
                                                  FeatureCache)

    t0 = time.perf_counter()
    pipe = CoarseFinePipeline(n_classes=157, version="M",
                              compute_dtype=torch.bfloat16, device="cuda",
                              generator=torch.Generator().manual_seed(0))
    build_s = time.perf_counter() - t0
    times = {"extract": [], "fuse": []}

    def timed(key, fn):
        def run(*args):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t1) * 1e3)
            return out
        return run

    server = CachingVideoServer(
        timed("extract", pipe.extract), timed("fuse", pipe.fuse),
        cache=FeatureCache(capacity_bytes=2 << 30), max_batch=3,
        max_wait_ms=2000, bucket_multiple=16, request_timeout_s=600,
        device="cuda").start()
    rng = torch.Generator().manual_seed(1)
    videos = {"A": (64, 128), "B": (64, 128), "C": (50, 100)}
    clips = {v: _clip(rng, t, 224) for v, (t, _) in videos.items()}
    fine = {v: _clip(rng, tf, 224) for v, (_, tf) in videos.items()}
    try:
        # warm-up on other video ids: library handles, allocator, autotune
        for f in [server.submit(clips[v], fine[v], video_id="warm" + v)
                  for v in videos]:
            f.result(timeout=600)
        times["extract"].clear()
        times["fuse"].clear()
        torch.cuda.reset_peak_memory_stats()

        dw_mm_act.reset_launches()
        lat, cold, hit = {}, {}, {}
        t1 = time.perf_counter()
        futs = {v: server.submit(clips[v], fine[v], video_id=v)
                for v in videos}
        for v, f in futs.items():
            cold[v] = f.result(timeout=600)
            lat["cold_" + v] = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        futs = {v: server.submit(clips[v], video_id=v) for v in videos}
        for v, f in futs.items():
            hit[v] = f.result(timeout=600)
            lat["hit_" + v] = (time.perf_counter() - t1) * 1e3
        launches = dict(dw_mm_act.LAUNCHES)
    finally:
        server.stop()

    for v, (t, _) in videos.items():
        for kind, out in (("cold", cold[v]), ("hit", hit[v])):
            check(out.shape == (4 * t, 157),
                  f"{kind} {v}: shape {out.shape} != {(4 * t, 157)}")
            check(bool(np.isfinite(out).all() and (out >= 0).all()
                       and (out <= 1).all()),
                  f"{kind} {v}: probabilities not finite or outside [0, 1]")
    hit_err = max(float(abs(hit[v] - cold[v]).max()) for v in videos)
    check(hit_err <= 1e-3, f"cache hit differs from cold result: {hit_err}")
    check(server.cache.hits == 3, f"cache hits {server.cache.hits} != 3")
    check(server.batch_sizes[-2:] == [3, 3],
          f"batches {server.batch_sizes}: cold and hit requests must each "
          "form one batch")
    # per extract or fuse call: 26 bottlenecks, 4 of them stride 2; the cold
    # batch runs extract + fuse, the hit batch fuse only
    check(launches == want, f"launches {launches} != {want}")
    emit({"phase": "serve", "model": "X3D-M", "n_classes": 157,
          "dtype": "bfloat16", "input_hw": 224,
          "videos": {v: {"T": t, "T_f": tf} for v, (t, tf) in videos.items()},
          "batch_sizes": server.batch_sizes, "latency_ms": lat,
          "extract_ms": times["extract"], "fuse_ms": times["fuse"],
          "launches": launches, "hit_max_abs_diff": hit_err,
          "prob_range": [float(min(c.min() for c in cold.values())),
                         float(max(c.max() for c in cold.values()))],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "pipeline_build_s": build_s})
    return launches, pipe


def phase_profile(pipe) -> None:
    """Device-time breakdown of one cold batch (extract + fuse, 3 videos at
    T=64/T_f=128, 224²) called directly, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(4)
    fine = torch.rand((3, 128, 224, 224, 3), generator=gen, device="cuda")
    clips = torch.rand((3, 64, 224, 224, 3), generator=gen, device="cuda")
    mask = torch.ones((3, 128), device="cuda")
    meta = torch.tensor([[0, 64, 128, 1]] * 3, dtype=torch.int32,
                        device="cuda")

    def batch():
        with torch.inference_mode():
            feats = pipe.extract(fine)
            return pipe.fuse(clips, feats, mask, meta, 256)

    batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ours_ms = sum(e.self_device_time_total for e in kernels
                  if "dw_mm_act" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit({"phase": "profile", "what": "one cold batch, extract + fuse, "
                                      "3 videos T=64/T_f=128 224² bf16",
          "wall_ms_profiled": wall_ms, "device_kernel_ms": device_ms,
          "device_busy_share": device_ms / wall_ms if wall_ms else None,
          "dw_mm_act_ms": ours_ms,
          "dw_mm_act_share": ours_ms / device_ms if device_ms else None,
          "kernel_launches": sum(e.count for e in kernels),
          "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                  for e in top]})


def phase_card_vs_cpu() -> None:
    from coarse_fine_networks_torch.models import CoarseFinePipeline

    cpu = CoarseFinePipeline(n_classes=157, device="cpu",
                             generator=torch.Generator().manual_seed(2))
    gpu = CoarseFinePipeline(n_classes=157, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = torch.Generator().manual_seed(3)
    t, tf, hw = 16, 32, 64
    clips = torch.rand((1, t, hw, hw, 3), generator=rng)
    fine = torch.rand((1, tf, hw, hw, 3), generator=rng)
    meta = torch.tensor([[0, t, tf - 4, 1]], dtype=torch.int32)
    mask = torch.ones((1, tf))
    mask[:, tf - 4:] = 0
    with torch.inference_mode():
        ref = cpu(clips, fine, meta, 4 * t, fine_mask=mask)
        got = gpu(clips.cuda(), fine.cuda(), meta.cuda(), 4 * t,
                  fine_mask=mask.cuda()).cpu()
        banks_ref = cpu.extract(fine)
        banks_gpu = gpu.extract(fine.cuda())
        banks = {k: v.cpu() for k, v in banks_gpu.items()}
        # the coarse stream's logits before the sigmoid: with random
        # weights the probabilities sit near 0.5 and carry little signal
        logits_ref = cpu.coarse(clips, banks_ref, mask, meta)
        logits = gpu.coarse(clips.cuda(), banks_gpu, mask.cuda(),
                            meta.cuda()).cpu()
    # f32 on both, TF32 off: summation order only.  Probabilities to 1e-4;
    # the feature banks and the coarse logits to 1e-4 of their largest
    # magnitude
    err = (got - ref).abs().max().item()
    tol = rel_tol = 1e-4

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    bank_err = {k: rel(banks[k], v) for k, v in banks_ref.items()}
    logit_err = rel(logits, logits_ref)
    emit({"phase": "card_vs_cpu", "dtype": "float32", "input_hw": hw,
          "T": t, "T_f": tf, "max_abs_err": err, "tol": tol,
          "bank_max_rel_err": bank_err, "logit_max_rel_err": logit_err,
          "rel_tol": rel_tol, "logit_absmax": logits_ref.abs().max().item(),
          "prob_std": ref.std().item()})
    check(max(bank_err.values()) <= rel_tol,
          f"card vs CPU feature banks differ: {bank_err}")
    check(logit_err <= rel_tol,
          f"card vs CPU coarse logits differ: {logit_err} > {rel_tol}")
    check(err <= tol, f"card vs CPU max abs err {err} > {tol}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "coarse_fine_networks_torch").is_dir():
        print("chip_smoke: coarse_fine_networks_torch not found beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from coarse_fine_networks_torch.ops import dw_mm_act

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device(dw_mm_act)
    per_kernel = phase_kernels(dw_mm_act)
    launches, pipe = phase_serve(
        dw_mm_act, {k: agg["launches"] for k, agg in per_kernel.items()})
    phase_profile(pipe)
    del pipe
    phase_card_vs_cpu()

    kernels = []
    for name, agg in per_kernel.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": agg["max_abs_err"],
            "max_abs_err_f32": agg["max_abs_err_f32"],
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"],
            "bound_by": ("bytes" if agg["bytes_ms"] >= agg["ops_ms"]
                         else "operations"),
            "library_ms": None, "unfused_ms": agg["unfused_ms"],
            "timed_at": "bf16 at the serve phase's entry shapes (B=3, 224²; "
                        "fine T_f=128; coarse T=64, then T=17 after Grid "
                        "Pool), each time weighted by its launches in the "
                        "counted serve run and summed"})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
