#!/usr/bin/env python3
"""Time the host entropy decoder's two paths on baseline frames.

    python3 entropy_paths.py

A baseline frame (one sequential Huffman scan over every component) takes
the decoder's single-scan path, decoded straight into the window's blocks
(``csrc/jpeg_entropy.cpp``'s ``decode_single``); every other frame takes
the coefficient buffer's path (``decode_buffered``), which reads a baseline
frame as well.  This builds the checkout's decoder twice into ``_build/``,
as it is and with the single-scan branch of ``decode_frame`` taken out,
and decodes 64 baseline 4:2:0 frames (noise and smooth, quality 90, as
``chip_smoke.py``'s ``_jpegs`` makes them) at each of ``chip_smoke.py``'s
``TIMED`` windows through each build at 1, 4 and 8 threads, in turns (as
it is, buffered, buffered, as it is, twice; the best of three calls a
turn).  Both builds must give the same coefficients.  Prints one JSON line
a window and kind (ms a frame of each path, and buffered over single),
then the host's CPU model and cores.  Needs a C++ compiler, no card;
imports no JAX.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

# decode_frame's fork: the single-scan path's condition
FORK = "  if (!hd.progressive && !hd.arithmetic && hd.first.ns == hd.ncomp) {"


def main() -> int:
    import chip_smoke as cs
    from coarse_fine_networks_torch.data import native
    from coarse_fine_networks_torch.ops import _build
    from coarse_fine_networks_torch.ops import scaled_decode as sd

    src = (_build.CSRC / "jpeg_entropy.cpp").read_text()
    if src.count(FORK) != 1:
        print("entropy_paths: decode_frame's fork not found", file=sys.stderr)
        return 2
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variant = _build.BUILD_DIR / "jpeg_entropy_buffered_only.cpp"
    variant.write_text(src.replace(FORK, "  if (false) {"))
    paths = {"single": sd.ENTROPY,
             "buffered": _build.HostLibrary(str(variant),
                                            sd.ENTROPY.functions)}
    n = 64
    names = [f"t{i}" for i in range(n)]
    for label, w, h, crop, out in cs.TIMED:
        box_of = (native.center_box if crop is None
                  else native.random_box(*crop))
        for kind in ("noise", "smooth"):
            clip = cs._jpegs(kind, 16, h, w, 50, 90) * (n // 16)
            p = sd.probe(clip[0])
            g = sd.geometry(w, h, p.samp, box_of(w, h), out)

            def decode(path, threads):
                sd.ENTROPY = paths[path]
                try:
                    t1 = time.perf_counter()
                    coefs, qt = sd.entropy_decode(clip, names, p, g, threads)
                    return (time.perf_counter() - t1) * 1e3 / n, coefs, qt
                finally:
                    sd.ENTROPY = paths["single"]

            a, b = decode("single", 1), decode("buffered", 1)
            if not (a[1].equal(b[1]) and a[2].equal(b[2])):
                print(f"entropy_paths: {label} {kind}: the paths differ",
                      file=sys.stderr)
                return 1
            ms = {(path, t): [] for path in paths for t in (1, 4, 8)}
            for _ in range(2):
                for t in (1, 4, 8):
                    for path in ("single", "buffered", "buffered", "single"):
                        ms[path, t].append(min(decode(path, t)[0]
                                               for _ in range(3)))
            row = {"window": label, "kind": kind, "frames": n, "num": g.num,
                   "size": [w, h], "box": list(g.box)}
            for t in (1, 4, 8):
                single, buffered = min(ms["single", t]), min(
                    ms["buffered", t])
                row[f"{t}_threads"] = {
                    "single_ms_per_frame": single,
                    "buffered_ms_per_frame": buffered,
                    "buffered_over_single": buffered / single,
                    "turns_single": ms["single", t],
                    "turns_buffered": ms["buffered", t]}
            print(json.dumps(row), flush=True)
    model = platform.processor() or platform.machine()
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), model)
    print(json.dumps({"cpu": model, "cores": os.cpu_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
