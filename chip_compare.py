#!/usr/bin/env python3
"""Time the port's depthwise kernels of two checkouts on one card, in turns.

    python3 chip_compare.py PARENT [CHANGE]
    python3 chip_compare.py --decode PARENT [CHANGE]

PARENT and CHANGE (default: this checkout) are checkout directories, each
holding its own ``chip_smoke.py`` and ``coarse_fine_networks_torch``.  Runs
go parent, change, change, parent, each in a process of its own that
imports its checkout's ``chip_smoke.py``, builds that checkout's kernels
into its own build directory, and times the eval entry's kernels
(``phase_kernels``: K1 and K4 ``mm`` at the serve run's and the fine eval
step's entry shapes), the train kernels (``phase_train_kernels``: the act
route's at the coarse step's and long-cycle phase D's entry shapes), the
split route's (``phase_fine_kernels``: long-cycle phases A-C), the
composite's backward (``phase_mm_train_kernels``: K2, K9, K6 and K10
``mm`` at the coarse step's and phase D's) and the plain-layout stencils
(``phase_stencil_kernels``: K11 and its taps' gradient at the stem's
shapes, K7), each held against its plain version there as
``chip_smoke.py`` holds it.  Each run prints one JSON
line: every kernel's bf16 time weighted by its launches on its path, as
``chip_smoke.py``'s ``kernels`` line sums it (``ms``; the train kernels'
also over one phase-D step, ``phase_d_ms``).  With ``--decode`` each run
times ``idct_rgb_kernel`` alone instead, as ``chip_smoke.py``'s
``fast_decode`` phase does: bare launches (``queued_ms``) on one clip's 64
4:2:0 noise frames (``_jpegs``, seed 50, quality 90) at each of its
``TIMED`` windows, held equal to ``idct_rgb_plain`` on the card, and its
registers and spills (``nvcc -Xptxas -v``).  The
card's ``nvidia-smi`` name and power limit come last.  Needs a CUDA card;
imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path


def run(tree: str, label: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke as cs
    from coarse_fine_networks_torch.ops import (_build, dw_act, dw_conv,
                                                dw_mm_act, dw_mm_bn_train,
                                                dw_stencil)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(dw_conv.LIBRARIES + (dw_stencil.LIBRARY,))
    with contextlib.redirect_stdout(io.StringIO()):
        per = cs.phase_kernels(dw_mm_act, dw_conv)
        per.update(cs.phase_train_kernels(dw_act, dw_conv, dw_mm_act))
        per.update(cs.phase_fine_kernels(dw_conv, dw_stencil))
        per.update(cs.phase_mm_train_kernels(dw_mm_act, dw_mm_bn_train,
                                             dw_conv))
        per.update(cs.phase_stencil_kernels(dw_stencil, dw_conv))
    print(json.dumps({"tree": label, "kernels": {
        k: {"ms": v["ms"], "phase_d_ms": v.get("phase_d_ms", 0.0),
            **({"by_path": {p: r["ms"] for p, r in v["by_path"].items()}}
               if "by_path" in v else {})}
        for k, v in per.items()}}), flush=True)


def run_decode(tree: str, label: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke as cs
    from coarse_fine_networks_torch.data import native
    from coarse_fine_networks_torch.ops import scaled_decode as sd

    dev = torch.device("cuda")
    n = 64
    names = [f"t{i}" for i in range(n)]
    lib = sd.LIBRARY.build()
    per = {}
    for shape, w, h, crop, out in cs.TIMED:
        box_of = (native.center_box if crop is None
                  else native.random_box(*crop))
        clip = cs._jpegs("noise", 16, h, w, 50, 90) * (n // 16)
        p = sd.probe(clip[0])
        g = sd.geometry(w, h, p.samp, box_of(w, h), out)
        coefs, qt = sd.entropy_decode(clip, names, p, g, 8, pin=True)
        cc, qc = coefs.to(dev), qt.to(dev)
        rgb = sd.idct_rgb(cc, qc, g)
        cs.check(cs._diff(rgb, sd.idct_rgb_plain(cc, qc, g))[0] == 0,
                 f"{label} {shape}: idct_rgb_kernel differs from its plain "
                 f"version")
        pitch = sd.window_pitch(g)
        buf = torch.empty((n, g.height, pitch), dtype=torch.uint8, device=dev)
        args = (cc.data_ptr(), qc.data_ptr(), n, sd.geom_array(g).ctypes.data,
                buf.data_ptr(), g.height * pitch, pitch,
                torch.cuda.current_stream().cuda_stream)
        per[shape] = {"ms": cs.queued_ms(lambda: lib.cfn_idct_rgb(*args),
                                         50)["ms"],
                      "num": g.num, "window": [g.height, g.width]}
    ptxas = [v for k, v in cs._ptxas(sd.LIBRARY.source).items()
             if "idct_rgb_kernel" in k]
    print(json.dumps({"tree": label, "idct_rgb_kernel": per,
                      "ptxas": ptxas}), flush=True)


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--run":
        (run_decode if sys.argv[4] == "decode" else run)(sys.argv[2],
                                                         sys.argv[3])
        return 0
    args = sys.argv[1:]
    what = "kernels"
    if args[:1] == ["--decode"]:
        what, args = "decode", args[1:]
    if len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    trees = {"parent": args[0], "change": args[1] if len(args) == 2 else "."}
    for label in ("parent", "change", "change", "parent"):
        subprocess.run([sys.executable, __file__, "--run", trees[label],
                        label, what], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
