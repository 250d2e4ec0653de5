#!/usr/bin/env python3
"""The redesigned kernels with no TPU counterpart, on one card: the three
stride-(2, 2, 2) kernels (``dw_conv_t2``, ``dw_conv_dx_t2``,
``dw_conv_wgrad_t2``) and the crop (``crop_resize_kernel``), against a
parent checkout and against variants of this one.

    python3 chip_rule2.py PARENT

PARENT is a checkout directory of the parent commit holding its
``coarse_fine_networks_torch`` (``git archive <commit>
coarse_fine_networks_torch | tar -x -C _scratch/parent``).  In order:

1. ``ptxas``: ``nvcc -cubin -Xptxas -v`` of both trees'
   ``csrc/dw_plain_s2.cu``; every row other than the three t2 kernels'
   compared (registers, spills, static shared memory; the anonymous
   namespace's per-file hash taken out of the names), and the t2 rows of
   both printed.  Exit 1 if a compared row differs or is gone.
2. ``turns``: parent, change, change, parent, a process each that builds
   its tree's kernels into its own build directory and times the three t2
   kernels at ``FineNet(t_downsample)``'s four B32 T16 224² entries in bf16
   and f32 (the call back to back, ``ms``, and its device time,
   ``device_ms``; each held against the plain version within
   ``chip_smoke.py``'s tolerance first, the run failing otherwise; each
   kernel's sums over the entries in ``sums``) and ``crop_resize`` on one
   clip's 64 frames of 640×480 in a pitched buffer (the centre and a train
   crop to 224²; call and device time, checked against the plain version)
   beside ``F.interpolate`` on the f32 crop.
3. ``variants``: copies of this checkout's package under
   ``_scratch/rule2_variants`` (gitignored), each with one edit, timed at
   the four entries in bf16 (device time): of the weight gradient,
   ``loads_only`` (no sums), ``sums_only`` (no loads after the first
   step), ``ahead_2`` (a ring of 7 x and 3 g frames, two steps ahead),
   ``pairs_only`` (K10 plain's per-pair copies, never the whole-pixel
   16-byte mode) and ``groups_32`` (channel groups of at most 32 pairs at
   every width); of the forward, ``fwd_cp16`` (whole pixels by the weight
   gradient's 16-byte cp.async copies, ``t2_stage_whole``, not bulk
   copies), ``fwd_pairs_only`` (per-pair copies at every width),
   ``fwd_frame_barriers`` (a barrier per input frame, as K4 plain's body at
   a temporal stride of 2 had) and ``fwd_ahead_2`` (a ring two steps deep);
   of the dx, ``dx_direct`` (each thread's pairs stored straight to dx,
   K8's body's write path).  The wrappers choose the whole-pixel modes
   (``dw_conv.t2_whole``), so the per-pair variants edit the wrappers.

Each run prints one JSON line; the card's ``nvidia-smi`` name and power
limit come last.  The timing helpers are this checkout's
``chip_smoke.py``'s.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import importlib.util
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
VARIANTS_DIR = HERE / "_scratch" / "rule2_variants"
PKG = "coarse_fine_networks_torch"
# FineNet(t_downsample)'s conv2 inputs at B32 T16 224² (chip_smoke.py's
# T2_SHAPES["B32.224"])
T2_ENTRIES = [(32, 16, 112, 112, 54), (32, 8, 56, 56, 108),
              (32, 4, 28, 28, 216), (32, 2, 14, 14, 432)]
# the variants that leave out loads or sums: their outputs are wrong
INEXACT = ("loads_only", "sums_only")
# name: (edits of csrc/dw_plain_s2.cu, edits of ops/dw_conv.py, the t2
# kernels it times)
WG, FWD, DX = ["dw_conv_wgrad_t2"], ["dw_conv_t2"], ["dw_conv_dx_t2"]
VARIANTS = {
    "loads_only": ([(
        "    if (wl < WB && tl.w0 + wl < Wo) {  // the thread's column exists",
        "    if (steps < 0) {")], [], WG),
    "sums_only": ([(
        "    __syncthreads();\n    load(s + 1);",
        "    __syncthreads();\n    cp_commit();")], [], WG),
    "ahead_2": ([
        ("constexpr int T2_XSLOTS = 5;", "constexpr int T2_XSLOTS = 7;"),
        ("constexpr int T2_GSLOTS = 2;", "constexpr int T2_GSLOTS = 3;"),
        ("  load(0);\n  for (int s = 0; s < steps; ++s) {",
         "  load(0);\n  load(1);\n  for (int s = 0; s < steps; ++s) {"),
        ("    cp_wait<0>();\n    __syncthreads();\n    load(s + 1);",
         "    cp_wait<1>();\n    __syncthreads();\n    load(s + 2);")],
        [("T2_XSLOTS, T2_GSLOTS = 5, 2", "T2_XSLOTS, T2_GSLOTS = 7, 3")], WG),
    "pairs_only": ([], [("p.ipb, p.rows, int(t2_whole(p, x))",
                         "p.ipb, p.rows, 0")], WG),
    "groups_32": ([], [(
        "    return _persistent(_strips(b, _t2(t), ho, wo, c, smem_t2,\n"
        "                               _pairs_first(c)))",
        "    return _persistent(_strips(b, _t2(t), ho, wo, c, smem_t2,\n"
        "                               DX_PG))")], WG),
    # the forward: whole pixels by 16-byte cp.async (t2_stage_whole) in
    # the step's commit group, not by bulk copies on mbarriers
    "fwd_cp16": ([
        ("  constexpr bool BULK = WHOLE;", "  constexpr bool BULK = false;"),
        ("    } else {\n      if (in)\n        T2Stager(",
         "    } else if constexpr (WHOLE) {\n      if (in)\n"
         "        t2_stage_whole(slot, xb + (size_t)ti * frame, hs, 2 * R + 1,"
         " H, W, C, p0, 2 * WB + 1, rowb);\n"
         "    } else {\n      if (in)\n        T2Stager(")], [], FWD),
    # ... every group by each thread's pairs (T2Stager)
    "fwd_pairs_only": ([], [("whole = (int(t2_whole(p, x)),) if",
                             "whole = (0,) if")], FWD),
    # ... a barrier per input frame (the count of K4 plain's body at a
    # temporal stride of 2), the second after the step's second frame
    "fwd_frame_barriers": ([(
        "    wait(2 * s + 2);\n    if (live && f0 + 2 * s + 2 < Tn)",
        "    wait(2 * s + 2);\n    __syncthreads();\n"
        "    if (live && f0 + 2 * s + 2 < Tn)")], [], FWD),
    # ... a ring two steps deep
    "fwd_ahead_2": ([("constexpr int T2F_AHEAD = 1;",
                      "constexpr int T2F_AHEAD = 2;")],
                    [("T2F_AHEAD = 1", "T2F_AHEAD = 2")], FWD),
    # the dx: each thread's pairs straight to dx, 4 (bf16) or 8 (f32) bytes
    # a store (the write path of K8's body at ST = 2)
    "dx_direct": ([], [("p.tt,\n                int(t2_whole(p, dx)))",
                        "p.tt,\n                0)")], DX),
}


def _helpers():
    """This checkout's chip_smoke.py (cuda_ms, queued_ms), loaded by path so
    that a tree's own package stays first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas(source: Path) -> dict:
    from coarse_fine_networks_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", "/dev/null",
         str(source)], capture_output=True, text=True, check=True)
    rows, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_\d+_\w+?_cu_\w{8}", "",
                          m.group(1))
            rows[name] = {}
        elif name and "spill stores" in line:
            rows[name]["spills"] = sum(map(int, re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line)))
        elif name and "Used" in line and "registers" in line:
            rows[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                    line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return rows


# the stride-(2, 2, 2) kernels: name -> (the wrapper's call, its plain
# version), each of (dw_conv, x, k, g, thw)
T2_CALLS = {
    "dw_conv_t2": (lambda m, x, k, g, thw: m.dw_conv3d(x, k, m.T2),
                   lambda m, x, k, g, thw: m.dw_conv3d_plain(x, k, m.T2)),
    "dw_conv_dx_t2": (lambda m, x, k, g, thw: m.dw_conv_dx_t2(g, k, thw),
                      lambda m, x, k, g, thw: m.dw_conv_dx_t2_plain(g, k,
                                                                    thw)),
    "dw_conv_wgrad_t2": (lambda m, x, k, g, thw: m.dw_conv_wgrad(x, g, m.T2),
                         lambda m, x, k, g, thw: m.dw_conv_wgrad_plain(
                             x, g, m.T2)),
}


def time_tree(root: str, label: str, kernels, crop: bool, dtypes) -> None:
    """One tree's times (a process of its own, the tree first on
    sys.path): one JSON line.  Each t2 kernel of ``kernels`` at each entry
    and dtype: its call back to back (``ms``) and its device time
    (``device_ms``), after its output is held against the plain version
    within chip_smoke.py's tolerance (the script fails otherwise; the
    variants in ``INEXACT`` leave out work by design and only record their
    error)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.nn.functional as F

    from coarse_fine_networks_torch.data import native
    from coarse_fine_networks_torch.ops import dw_conv
    from coarse_fine_networks_torch.ops import frame_decode as fd

    cs = _helpers()
    torch.backends.cuda.matmul.allow_tf32 = False
    dw_conv.LIBRARY_S2.build()
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {"tree": label, "t2": [], "crop": {}}
    for dtype in dtypes:
        for b, t, h, w, c in T2_ENTRIES:
            x = torch.randn((b, t, h, w, c), generator=gen,
                            device="cuda").relu().to(dtype)
            k = (torch.randn((3, 3, 3, c), generator=gen, device="cuda")
                 / 27 ** 0.5).to(dtype)
            g = torch.randn((b, (t - 1) // 2 + 1, (h - 1) // 2 + 1,
                             (w - 1) // 2 + 1, c), generator=gen,
                            device="cuda").to(dtype)
            for name in kernels:
                kern, plain = T2_CALLS[name]

                def call():
                    return kern(dw_conv, x, k, g, (t, h, w))

                got = call()
                ref = plain(dw_conv, x, k, g, (t, h, w))
                err, scale = cs._rel_err(got, ref)
                tol = cs.TOL[dtype] * max(scale, 1.0)
                if not err <= tol and label not in INEXACT:
                    raise SystemExit(f"{label} {name} {(b, t, h, w, c)} "
                                     f"{dtype}: max abs err {err} > {tol}")
                out["t2"].append({
                    "kernel": name, "x": [b, t, h, w, c],
                    "dtype": str(dtype)[6:], "max_abs_err": err,
                    "ref_absmax": scale, "ms": cs.cuda_ms(call, 20),
                    "device_ms": cs.queued_ms(call, 20)["ms"]})
                del got, ref
            del x, k, g
    if crop:
        fd.LIBRARY.build()
        n, hh, ww = 64, 480, 640
        buf = torch.randint(0, 256, (n, hh, fd._pitch(ww, 3)), generator=gen,
                            device="cuda", dtype=torch.uint8)
        raw = buf[:, :, :ww * 3].view(n, hh, ww, 3)
        for name, box_of in (("centre", native.center_box),
                             ("train", native.random_box(224 / 320, 0.3,
                                                         0.6))):
            box = box_of(ww, hh)
            # as the tree's decode_crop_resize passes them: a broadcast
            # array where the wrapper packs the boxes itself, else a list
            boxes = (np.broadcast_to(np.asarray(box, np.int64), (n, 4))
                     if hasattr(fd, "crop_launches") else [box] * n)
            x1, y1, cw, ch = box
            crop_f32 = raw[:, y1:y1 + ch, x1:x1 + cw].permute(
                0, 3, 1, 2).float().contiguous()

            def call():
                return fd.crop_resize(raw, boxes, 224)

            def library():
                return F.interpolate(crop_f32, size=(224, 224),
                                     mode="bilinear", align_corners=False,
                                     antialias=False)

            err = int((call().int() - fd.crop_resize_plain(
                raw, boxes, 224).int()).abs().max())
            out["crop"][name] = {
                "max_abs_err": err, "call_ms": cs.cuda_ms(call, 20),
                "device_ms": cs.queued_ms(call, 50)["ms"],
                "library_ms": cs.cuda_ms(library, 20),
                "library_device_ms": cs.queued_ms(library, 20)["ms"]}
    # each kernel's bf16 sums over the four entries
    out["sums"] = {
        f"{name}.{dt}": {key: sum(r[key] for r in out["t2"]
                                  if r["kernel"] == name and r["dtype"] == dt)
                         for key in ("ms", "device_ms")}
        for name in kernels for dt in {r["dtype"] for r in out["t2"]}}
    print(json.dumps(out), flush=True)


def _variant(name: str) -> Path:
    """A copy of this checkout's package with the variant's edits."""
    root = VARIANTS_DIR / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, edits in zip(("csrc/dw_plain_s2.cu", "ops/dw_conv.py"),
                          VARIANTS[name][:2]):
        path = root / PKG / rel
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        path.write_text(text)
    return root


def _build(root: Path, crop: bool) -> None:
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            "from coarse_fine_networks_torch.ops import dw_conv, "
            "frame_decode; dw_conv.LIBRARY_S2.build()"
            + ("; frame_decode.LIBRARY.build()" if crop else ""))
    subprocess.run([sys.executable, "-c", code], check=True)


def _run(root: Path, label: str, kernels, crop: bool, dtypes: str) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, "--time", str(root), label,
         ",".join(kernels), "crop" if crop else "-", dtypes],
        capture_output=True, text=True)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
    if proc.returncode or not lines:
        raise SystemExit(f"{label}: rc {proc.returncode}\n"
                         f"{proc.stderr[-3000:]}")
    print(lines[-1], flush=True)
    return json.loads(lines[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_rule2: no CUDA device", file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    if not (parent / PKG).is_dir() or not (HERE / PKG).is_dir():
        print(f"chip_rule2: {PKG} not found in {parent} or beside this "
              f"script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    roots = {"parent": parent, "change": HERE}
    roots.update({name: _variant(name) for name in VARIANTS})
    src = Path(PKG) / "csrc" / "dw_plain_s2.cu"
    with ThreadPoolExecutor(max_workers=8) as pool:
        rows = {k: pool.submit(_ptxas, roots[k] / src)
                for k in ("parent", "change")}
        builds = [pool.submit(_build, r, k in ("parent", "change"))
                  for k, r in roots.items()]
        for f in builds:
            f.result()
        rows = {k: f.result() for k, f in rows.items()}
    # the rows of every kernel but the three t2 kernels must be the parent's
    others = [n for n in rows["change"] if "plain_t2_" not in n]
    differ = {n: (rows["parent"].get(n), rows["change"][n]) for n in others
              if rows["parent"].get(n) != rows["change"][n]}
    gone = [n for n in rows["parent"]
            if "plain_t2_" not in n and n not in rows["change"]]
    print(json.dumps({"ptxas": "dw_plain_s2.cu", "rows_compared":
                      len(others), "differ": differ, "gone": gone,
                      "t2_change": {n: v for n, v in rows["change"].items()
                                    if "plain_t2_" in n},
                      "t2_parent": {n: v for n, v in rows["parent"].items()
                                    if "plain_t2_" in n}}), flush=True)
    for label in ("parent", "change", "change", "parent"):
        _run(roots[label], label, list(T2_CALLS), True, "bfloat16,float32")
    for name, (_, _, kernels) in VARIANTS.items():
        _run(roots[name], name, kernels, False, "bfloat16")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 1 if differ or gone else 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--time":
        import torch

        time_tree(sys.argv[2], sys.argv[3], sys.argv[4].split(","),
                  sys.argv[5] == "crop",
                  [getattr(torch, d) for d in sys.argv[6].split(",")])
    else:
        sys.exit(main())
